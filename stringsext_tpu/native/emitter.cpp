// Native emission engine: scalar decode-event classifiers + the exact
// emission automaton, C ABI for ctypes.
//
// This is the host-side runtime counterpart of the device kernels: the
// reference's hot loops (encoding_rs DFA + SplitStr walk) re-implemented
// as a single-pass scalar engine whose OBSERVABLE OUTPUT is bit-identical
// with stringsext_tpu.engine.{events,automaton} (fuzz-tested against the
// Python path, which is itself conformance-tested against the reference
// golden corpus /root/reference/tests/functional).
//
// Supported kinds: UTF-8, UTF-16LE/BE, single-byte (table-driven),
// EUC-KR, Big5, Shift_JIS, EUC-JP, GBK/gb18030, modal ISO-2022-JP.
//
// Build: g++ -O3 -shared -fPIC -o libemitter.so emitter.cpp

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unistd.h>
#include <vector>

namespace {

struct Mission {
    uint64_t af_lo, af_hi;  // 128-bit AF filter
    uint64_t ubf;           // 64-bit UBF filter
    int32_t grep_char;      // -1 = none
    int32_t chars_min_nb;
    int32_t line_max;       // output_line_char_nb_max
    int32_t same_block;
    uint64_t counter_offset;
    // 0 utf8, 1 utf16le, 2 utf16be, 3 single-byte,
    // 4 euc-kr, 5 big5, 6 shift_jis (two-byte kinds, pair table),
    // 7 euc-jp, 8 gb18030/gbk
    int32_t kind;
    const int32_t* table256;
    const int32_t* pair_cp;    // [256*256] cp or -1 (kinds 4-8 2-byte)
    const int32_t* pair_cp2;   // EUC-JP jis0212 [256*256] via (t2,t3)
    const int64_t* gb_ptrs;    // gb18030 4-byte range pointers (sorted)
    const int32_t* gb_cps;     // cp at each range pointer
    int32_t gb_nranges;
    const int32_t* multi_keys; // sorted lead*256+trail of double-cp pairs
    const int32_t* multi_cp1;
    const int32_t* multi_cp2;
    int32_t n_multi;
    // Findings whose bytes are a verbatim input span may carry
    // SE_INREF-flagged str_off values (offsets into the INPUT buffer,
    // no strbuf copy). Only set when the caller's output path resolves
    // the flag (se_merge_fd with inbufs).
    int32_t input_refs = 0;
};

// str_off bit 63: the offset addresses the input buffer, not strbuf.
static constexpr uint64_t SE_INREF = 1ull << 63;

// Findings are stored struct-of-arrays for clean numpy interop.
struct Output;

struct Event {
    int64_t pos;
    int32_t in_len;
    int32_t cp;  // -1 malformed
    int32_t cp2 = 0;  // second codepoint (rare Big5 double-cp pairs)
    int64_t report;
    int32_t pushback;
};

// Decoder state for modal encodings (ISO-2022-JP). Stateless kinds
// ignore it. mode: 0 ASCII, 1 Roman, 2 Katakana, 3 jis0208 lead.
struct DecState {
    int32_t mode = 0;
    bool output_flag = false;
};

// ---------- scalar event classifiers (mirror engine/events.py) ----------

// UTF-8: sequential walk; returns false when the event at p would need
// bytes beyond n (pending at stream end).
static inline bool utf8_next(const uint8_t* d, int64_t n, int64_t p, Event* ev) {
    uint8_t b = d[p];
    ev->pos = p;
    ev->pushback = 0;
    ev->cp2 = 0;
    if (b < 0x80) {
        ev->in_len = 1; ev->cp = b; ev->report = p; return true;
    }
    auto cont = [&](int64_t i) { return i < n && (d[i] & 0xC0) == 0x80; };
    auto have = [&](int64_t i) { return i < n; };
    if (b >= 0xC2 && b <= 0xDF) {
        if (!have(p + 1)) return false;  // pending
        if (cont(p + 1)) {
            ev->in_len = 2; ev->cp = ((b & 0x1F) << 6) | (d[p + 1] & 0x3F);
            ev->report = p + 1; return true;
        }
        ev->in_len = 1; ev->cp = -1; ev->report = p + 1; return true;
    }
    if (b >= 0xE0 && b <= 0xEF) {
        if (!have(p + 1)) return false;
        bool c1ok = cont(p + 1) &&
                    !(b == 0xE0 && d[p + 1] < 0xA0) &&
                    !(b == 0xED && d[p + 1] > 0x9F);
        if (!c1ok) { ev->in_len = 1; ev->cp = -1; ev->report = p + 1; return true; }
        if (!have(p + 2)) return false;
        if (cont(p + 2)) {
            ev->in_len = 3;
            ev->cp = ((b & 0x0F) << 12) | ((d[p + 1] & 0x3F) << 6) | (d[p + 2] & 0x3F);
            ev->report = p + 2; return true;
        }
        ev->in_len = 2; ev->cp = -1; ev->report = p + 2; return true;
    }
    if (b >= 0xF0 && b <= 0xF4) {
        if (!have(p + 1)) return false;
        bool c1ok = cont(p + 1) &&
                    !(b == 0xF0 && d[p + 1] < 0x90) &&
                    !(b == 0xF4 && d[p + 1] > 0x8F);
        if (!c1ok) { ev->in_len = 1; ev->cp = -1; ev->report = p + 1; return true; }
        if (!have(p + 2)) return false;
        if (!cont(p + 2)) { ev->in_len = 2; ev->cp = -1; ev->report = p + 2; return true; }
        if (!have(p + 3)) return false;
        if (cont(p + 3)) {
            ev->in_len = 4;
            ev->cp = ((b & 0x07) << 18) | ((d[p + 1] & 0x3F) << 12) |
                     ((d[p + 2] & 0x3F) << 6) | (d[p + 3] & 0x3F);
            ev->report = p + 3; return true;
        }
        ev->in_len = 3; ev->cp = -1; ev->report = p + 3; return true;
    }
    // stray continuation / C0 / C1 / F5-FF: intrinsic 1-byte malformed
    ev->in_len = 1; ev->cp = -1; ev->report = p; return true;
}

static inline bool utf16_next(const uint8_t* d, int64_t n, int64_t p, bool be, Event* ev) {
    if (p + 1 >= n) return false;  // half unit pending
    uint32_t u = be ? (d[p] << 8) | d[p + 1] : (d[p + 1] << 8) | d[p];
    ev->pos = p; ev->pushback = 0; ev->cp2 = 0;
    bool high = u >= 0xD800 && u <= 0xDBFF;
    bool low = u >= 0xDC00 && u <= 0xDFFF;
    if (!high && !low) { ev->in_len = 2; ev->cp = (int32_t)u; ev->report = p + 1; return true; }
    if (low) { ev->in_len = 2; ev->cp = -1; ev->report = p + 1; return true; }
    // high surrogate: need the next unit to decide
    if (p + 3 >= n) return false;  // pending lone high at stream end
    uint32_t u2 = be ? (d[p + 2] << 8) | d[p + 3] : (d[p + 3] << 8) | d[p + 2];
    if (u2 >= 0xDC00 && u2 <= 0xDFFF) {
        ev->in_len = 4;
        ev->cp = 0x10000 + ((u & 0x3FF) << 10) + (u2 & 0x3FF);
        ev->report = p + 3; return true;
    }
    ev->in_len = 2; ev->cp = -1; ev->report = p + 3; ev->pushback = 2;
    return true;
}

// Two-byte CJK kinds (EUC-KR / Big5 / Shift_JIS / GBK 2-byte): WHATWG
// error semantics - an invalid pair with an ASCII trail pushes the
// trail back (malformed = lead only); a non-ASCII trail is consumed.
static inline bool cjk2_next(const Mission& m, const uint8_t* d, int64_t n,
                             int64_t p, Event* ev) {
    uint8_t b = d[p];
    ev->pos = p; ev->pushback = 0; ev->cp2 = 0;
    if (m.kind == 6) {  // Shift_JIS singles
        if (b <= 0x80) { ev->in_len = 1; ev->cp = b; ev->report = p; return true; }
        if (b >= 0xA1 && b <= 0xDF) {
            ev->in_len = 1; ev->cp = 0xFF61 - 0xA1 + b; ev->report = p; return true;
        }
        bool lead = (b >= 0x81 && b <= 0x9F) || (b >= 0xE0 && b <= 0xFC);
        if (!lead) { ev->in_len = 1; ev->cp = -1; ev->report = p; return true; }
    } else {
        if (b < 0x80) { ev->in_len = 1; ev->cp = b; ev->report = p; return true; }
        if (b < 0x81 || b > 0xFE) {
            ev->in_len = 1; ev->cp = -1; ev->report = p; return true;
        }
    }
    if (p + 1 >= n) return false;  // pending lead
    uint8_t t = d[p + 1];
    int32_t cp = m.pair_cp[(int32_t)b * 256 + t];
    if (cp >= 0) { ev->in_len = 2; ev->cp = cp; ev->report = p + 1; return true; }
    if (m.n_multi > 0) {  // Big5 double-codepoint pairs
        int32_t key = (int32_t)b * 256 + t;
        for (int32_t i = 0; i < m.n_multi; i++) {
            if (m.multi_keys[i] == key) {
                ev->in_len = 2; ev->cp = m.multi_cp1[i];
                ev->cp2 = m.multi_cp2[i]; ev->report = p + 1;
                return true;
            }
        }
    }
    if (t < 0x80) {  // ASCII trail pushed back
        ev->in_len = 1; ev->cp = -1; ev->report = p + 1; ev->pushback = 1;
        return true;
    }
    ev->in_len = 2; ev->cp = -1; ev->report = p + 1; return true;
}

static inline bool eucjp_next(const Mission& m, const uint8_t* d, int64_t n,
                              int64_t p, Event* ev) {
    uint8_t b = d[p];
    ev->pos = p; ev->pushback = 0; ev->cp2 = 0;
    if (b < 0x80) { ev->in_len = 1; ev->cp = b; ev->report = p; return true; }
    if (b == 0x8E) {
        if (p + 1 >= n) return false;
        uint8_t t = d[p + 1];
        if (t >= 0xA1 && t <= 0xDF) {
            ev->in_len = 2; ev->cp = 0xFF61 - 0xA1 + t; ev->report = p + 1;
            return true;
        }
        if (t < 0x80) { ev->in_len = 1; ev->cp = -1; ev->report = p + 1;
                        ev->pushback = 1; return true; }
        ev->in_len = 2; ev->cp = -1; ev->report = p + 1; return true;
    }
    if (b == 0x8F) {
        if (p + 1 >= n) return false;
        uint8_t t2 = d[p + 1];
        if (!(t2 >= 0xA1 && t2 <= 0xFE)) {
            if (t2 < 0x80) { ev->in_len = 1; ev->cp = -1; ev->report = p + 1;
                             ev->pushback = 1; return true; }
            ev->in_len = 2; ev->cp = -1; ev->report = p + 1; return true;
        }
        if (p + 2 >= n) return false;
        uint8_t t3 = d[p + 2];
        int32_t cp = m.pair_cp2 ? m.pair_cp2[(int32_t)t2 * 256 + t3] : -1;
        if (cp >= 0) { ev->in_len = 3; ev->cp = cp; ev->report = p + 2;
                       return true; }
        if (t3 < 0x80) { ev->in_len = 2; ev->cp = -1; ev->report = p + 2;
                         ev->pushback = 1; return true; }
        ev->in_len = 3; ev->cp = -1; ev->report = p + 2; return true;
    }
    if (b >= 0xA1 && b <= 0xFE) {
        if (p + 1 >= n) return false;
        uint8_t t = d[p + 1];
        int32_t cp = m.pair_cp[(int32_t)b * 256 + t];
        if (cp >= 0) { ev->in_len = 2; ev->cp = cp; ev->report = p + 1;
                       return true; }
        if (t < 0x80) { ev->in_len = 1; ev->cp = -1; ev->report = p + 1;
                        ev->pushback = 1; return true; }
        ev->in_len = 2; ev->cp = -1; ev->report = p + 1; return true;
    }
    ev->in_len = 1; ev->cp = -1; ev->report = p; return true;
}

static inline bool gb18030_next(const Mission& m, const uint8_t* d, int64_t n,
                                int64_t p, Event* ev) {
    uint8_t b = d[p];
    ev->pos = p; ev->pushback = 0; ev->cp2 = 0;
    if (b < 0x80) { ev->in_len = 1; ev->cp = b; ev->report = p; return true; }
    // WHATWG gb18030 decoder step 7 (the GBK euro quirk): 0x80 is a
    // valid 1-byte U+20AC, not an error.
    if (b == 0x80) { ev->in_len = 1; ev->cp = 0x20AC; ev->report = p; return true; }
    if (b > 0xFE) {
        ev->in_len = 1; ev->cp = -1; ev->report = p; return true;
    }
    if (p + 1 >= n) return false;
    uint8_t b2 = d[p + 1];
    if (b2 >= 0x30 && b2 <= 0x39) {  // four-byte form
        if (p + 2 >= n) return false;
        uint8_t b3 = d[p + 2];
        if (!(b3 >= 0x81 && b3 <= 0xFE)) {
            ev->in_len = 1; ev->cp = -1; ev->report = p + 2; ev->pushback = 2;
            return true;
        }
        if (p + 3 >= n) return false;
        uint8_t b4 = d[p + 3];
        if (!(b4 >= 0x30 && b4 <= 0x39)) {
            ev->in_len = 1; ev->cp = -1; ev->report = p + 3; ev->pushback = 3;
            return true;
        }
        int64_t ptr = (int64_t)(b - 0x81) * 12600 + (b2 - 0x30) * 1260 +
                      (b3 - 0x81) * 10 + (b4 - 0x30);
        bool ok = (ptr <= 39419) || (ptr >= 189000 && ptr <= 1237575);
        if (ok && m.gb_nranges > 0) {
            // binary search the ranges table: last entry with
            // range_ptr <= ptr; cp = cps[i] + (ptr - ptrs[i]).
            int32_t lo = 0, hi = m.gb_nranges - 1;
            while (lo < hi) {
                int32_t mid = (lo + hi + 1) >> 1;
                if (m.gb_ptrs[mid] <= ptr) lo = mid; else hi = mid - 1;
            }
            ev->in_len = 4; ev->cp = m.gb_cps[lo] + (int32_t)(ptr - m.gb_ptrs[lo]);
            ev->report = p + 3; return true;
        }
        ev->in_len = 4; ev->cp = -1; ev->report = p + 3; return true;
    }
    if (b2 >= 0x40 && b2 <= 0xFE && b2 != 0x7F) {  // two-byte
        int32_t cp = m.pair_cp[(int32_t)b * 256 + b2];
        if (cp >= 0) { ev->in_len = 2; ev->cp = cp; ev->report = p + 1;
                       return true; }
        if (b2 < 0x80) { ev->in_len = 1; ev->cp = -1; ev->report = p + 1;
                         ev->pushback = 1; return true; }
        ev->in_len = 2; ev->cp = -1; ev->report = p + 1; return true;
    }
    if (b2 < 0x80) { ev->in_len = 1; ev->cp = -1; ev->report = p + 1;
                     ev->pushback = 1; return true; }
    ev->in_len = 2; ev->cp = -1; ev->report = p + 1; return true;
}

// ISO-2022-JP (kind 9): modal; may consume escape sequences silently,
// so it loops until an event materializes or input runs out. `p` is
// advanced past silently-consumed escapes via *p_io.
static inline bool iso2022_next(const Mission& m, const uint8_t* d, int64_t n,
                                int64_t* p_io, DecState* st, Event* ev) {
    for (;;) {
        int64_t p = *p_io;
        if (p >= n) return false;
        uint8_t b = d[p];
        ev->pos = p; ev->pushback = 0; ev->cp2 = 0;
        if (b == 0x1B) {
            if (p + 1 >= n) return false;  // pending escape
            uint8_t e1 = d[p + 1];
            if (e1 != 0x24 && e1 != 0x28) {
                ev->in_len = 1; ev->cp = -1; ev->report = p + 1; ev->pushback = 1;
                return true;
            }
            if (p + 2 >= n) return false;
            uint8_t e2 = d[p + 2];
            int32_t new_mode = -1;
            if (e1 == 0x28) {
                if (e2 == 0x42) new_mode = 0;
                else if (e2 == 0x4A) new_mode = 1;
                else if (e2 == 0x49) new_mode = 2;
            } else if (e2 == 0x40 || e2 == 0x42) new_mode = 3;
            if (new_mode < 0) {
                ev->in_len = 1; ev->cp = -1; ev->report = p + 2; ev->pushback = 2;
                return true;
            }
            bool was = st->output_flag;
            st->output_flag = true;
            st->mode = new_mode;
            *p_io = p + 3;
            if (was) {  // redundant escape -> error covering it
                ev->in_len = 3; ev->cp = -1; ev->report = p + 2;
                return true;
            }
            continue;  // silent transition
        }
        switch (st->mode) {
            case 0:
            case 1: {
                if (b < 0x80 && b != 0x0E && b != 0x0F) {
                    int32_t cp = b;
                    if (st->mode == 1) {
                        if (b == 0x5C) cp = 0x00A5;
                        else if (b == 0x7E) cp = 0x203E;
                    }
                    ev->in_len = 1; ev->cp = cp; ev->report = p;
                    st->output_flag = false;
                    return true;
                }
                // WHATWG: every consumed data-state byte unsets the
                // output flag, error paths included (the redundant-
                // escape error fires only for two escapes with NOTHING
                // between).
                st->output_flag = false;
                ev->in_len = 1; ev->cp = -1; ev->report = p;
                return true;
            }
            case 2: {
                if (b >= 0x21 && b <= 0x5F) {
                    ev->in_len = 1; ev->cp = 0xFF61 - 0x21 + b; ev->report = p;
                    st->output_flag = false;
                    return true;
                }
                st->output_flag = false;
                ev->in_len = 1; ev->cp = -1; ev->report = p;
                return true;
            }
            default: {  // jis0208 two-byte
                // WHATWG lead-byte state unsets the output flag for
                // every consumed byte (valid lead or error).
                st->output_flag = false;
                if (!(b >= 0x21 && b <= 0x7E)) {
                    ev->in_len = 1; ev->cp = -1; ev->report = p;
                    return true;
                }
                if (p + 1 >= n) return false;  // trail pending
                uint8_t t = d[p + 1];
                if (t == 0x1B) {  // ESC in trail state: incomplete pair
                    ev->in_len = 1; ev->cp = -1; ev->report = p + 1;
                    return true;
                }
                if (t >= 0x21 && t <= 0x7E && m.pair_cp) {
                    int32_t cp = m.pair_cp[((int32_t)b | 0x80) * 256 + (t | 0x80)];
                    if (cp >= 0) {
                        ev->in_len = 2; ev->cp = cp; ev->report = p + 1;
                        st->output_flag = false;
                        return true;
                    }
                }
                ev->in_len = 2; ev->cp = -1; ev->report = p + 1;
                return true;
            }
        }
    }
}

static inline bool next_event(const Mission& m, const uint8_t* d, int64_t n,
                              int64_t p, Event* ev) {
    switch (m.kind) {
        case 0: return utf8_next(d, n, p, ev);
        case 1: return utf16_next(d, n, p, false, ev);
        case 2: return utf16_next(d, n, p, true, ev);
        case 4:
        case 5:
        case 6: return cjk2_next(m, d, n, p, ev);
        case 7: return eucjp_next(m, d, n, p, ev);
        case 8: return gb18030_next(m, d, n, p, ev);
        default: {
            ev->pos = p; ev->in_len = 1; ev->cp = m.table256[d[p]];
            ev->report = p; ev->pushback = 0; return true;
        }
    }
}

// ---------- char helpers ----------

static inline int utf8_len_of(int32_t cp) {
    if (cp < 0x80) return 1;
    if (cp < 0x800) return 2;
    if (cp < 0x10000) return 3;
    return 4;
}

static inline int utf8_lead_of(int32_t cp) {
    if (cp < 0x80) return cp;
    if (cp < 0x800) return 0xC0 | (cp >> 6);
    if (cp < 0x10000) return 0xE0 | (cp >> 12);
    return 0xF0 | (cp >> 18);
}

static void utf8_append(std::vector<uint8_t>& out, int32_t cp) {
    if (cp < 0x80) { out.push_back((uint8_t)cp); return; }
    if (cp < 0x800) {
        out.push_back(0xC0 | (cp >> 6));
        out.push_back(0x80 | (cp & 0x3F));
        return;
    }
    if (cp < 0x10000) {
        out.push_back(0xE0 | (cp >> 12));
        out.push_back(0x80 | ((cp >> 6) & 0x3F));
        out.push_back(0x80 | (cp & 0x3F));
        return;
    }
    out.push_back(0xF0 | (cp >> 18));
    out.push_back(0x80 | ((cp >> 12) & 0x3F));
    out.push_back(0x80 | ((cp >> 6) & 0x3F));
    out.push_back(0x80 | (cp & 0x3F));
}

static inline bool pass_af(const Mission& m, int32_t cp) {
    return cp < 64 ? ((m.af_lo >> cp) & 1) : ((m.af_hi >> (cp - 64)) & 1);
}
static inline bool pass_ubf(const Mission& m, int lead) {
    return (m.ubf >> (lead & 0x3F)) & 1;
}

// ---------- SplitStr port (helper.rs:206-433 == automaton.split_str) ----

struct Chunk {
    int32_t start, end;
    bool completes, maybe_cut, filtered_again, min_ok, grep_ok;
};

// Stateful iterator over one call's chars.
struct SplitStr {
    const int32_t* cps;
    int32_t n;
    const Mission* m;
    bool last_maybe_cut;
    bool invalid_after;
    int32_t inp_start = 0, p = 0;
    bool done = false;

    bool next(Chunk* out) {
        if (done) return false;
        const Mission& mm = *m;
        bool grep_ok = mm.grep_char < 0;
        int32_t ok_s_p = p, ok_char_nb = 0, last_multi_lead = 0;
        while (p < n && ok_char_nb < mm.line_max) {
            int32_t cp = cps[p];
            bool char_ok, goto_next;
            if (cp < 0x80) {
                if (!grep_ok && mm.grep_char == cp) grep_ok = true;
                char_ok = pass_af(mm, cp);
                goto_next = true;
                if (char_ok) {
                    // ASCII burst: consume the run of accepted ASCII
                    // chars in one tight loop (ASCII never touches
                    // last_multi_lead, so the ladder below is a no-op
                    // for them). Dominant loop on text-dense input.
                    ok_char_nb++; p++;
                    while (p < n && ok_char_nb < mm.line_max) {
                        int32_t c2 = cps[p];
                        if ((uint32_t)c2 >= 0x80u || !pass_af(mm, c2)) break;
                        if (!grep_ok && mm.grep_char == c2) grep_ok = true;
                        ok_char_nb++; p++;
                    }
                    continue;
                }
            } else {
                int lead = utf8_lead_of(cp);
                if (pass_ubf(mm, lead)) {
                    if (!mm.same_block || lead == last_multi_lead || last_multi_lead == 0) {
                        last_multi_lead = lead; char_ok = true; goto_next = true;
                        if (!mm.same_block) {
                            // Multibyte burst (same_block off): accepted
                            // multibyte chars never touch grep_ok (grep
                            // chars are ASCII-only, mission.rs:547-555),
                            // so the run consumes in one tight loop.
                            ok_char_nb++; p++;
                            while (p < n && ok_char_nb < mm.line_max) {
                                int32_t c2 = cps[p];
                                if ((uint32_t)c2 < 0x80u) break;
                                int l2 = utf8_lead_of(c2);
                                if (!pass_ubf(mm, l2)) break;
                                last_multi_lead = l2;
                                ok_char_nb++; p++;
                            }
                            continue;
                        }
                    } else {
                        last_multi_lead = lead; char_ok = false; goto_next = false;
                    }
                } else {
                    last_multi_lead = 0; char_ok = false; goto_next = true;
                }
            }
            if (char_ok) { ok_char_nb++; p++; }
            else {
                if (goto_next) p++;
                if ((last_maybe_cut && ok_char_nb > 0 && ok_s_p == inp_start) ||
                    (ok_char_nb >= mm.chars_min_nb && grep_ok)) break;
                ok_char_nb = 0; ok_s_p = p; grep_ok = mm.grep_char < 0;
            }
        }
        if (ok_char_nb == 0) { done = true; return false; }
        bool left = ok_s_p == inp_start;
        bool right = ok_s_p + ok_char_nb >= n;
        bool maybe_cut = ok_char_nb >= mm.line_max || (right && !invalid_after);
        bool completes = left && last_maybe_cut;
        bool again = !completes && right && !invalid_after &&
                     (ok_char_nb < mm.line_max || !grep_ok);
        bool min_ok = ok_char_nb >= mm.chars_min_nb;
        if (!completes && !again && (!grep_ok || !min_ok)) { done = true; return false; }
        if (ok_char_nb >= mm.line_max) inp_start = p;
        last_maybe_cut = maybe_cut;
        out->start = ok_s_p; out->end = ok_s_p + ok_char_nb;
        out->completes = completes; out->maybe_cut = maybe_cut;
        out->filtered_again = again; out->min_ok = min_ok; out->grep_ok = grep_ok;
        return true;
    }
};

// ---------- fresh-decode heuristic (finding_collection.rs:155-207) ----

// Decode slice bytes from offset 0 with a fresh decoder into an 8-byte
// UTF-8 budget; stop at malformed / budget / end. Mirrors
// automaton._fresh_decode_prefix.
static void fresh_decode_prefix(const Mission& m, const uint8_t* d, int64_t n,
                                std::vector<uint8_t>& out) {
    out.clear();
    int64_t limit = n < 64 ? n : 64;
    int64_t p = 0;
    DecState fresh_state;
    while (p < limit) {
        Event ev;
        bool ok;
        if (m.kind == 9) ok = iso2022_next(m, d, limit, &p, &fresh_state, &ev);
        else ok = next_event(m, d, limit, p, &ev);
        if (!ok) break;  // pending == flush stop
        if (ev.cp < 0) break;
        // Budget per char (matches the Python oracle, which models
        // double-cp pairs as two events).
        if ((int)out.size() + utf8_len_of(ev.cp) > 8) break;
        utf8_append(out, ev.cp);
        if (ev.cp2) {
            if ((int)out.size() + utf8_len_of(ev.cp2) > 8) break;
            utf8_append(out, ev.cp2);
        }
        p = ev.pos + ev.in_len;
    }
}

// ---------- the automaton (automaton.SliceScanner, exact) -------------

struct Output {
    std::vector<uint64_t> position;
    std::vector<int8_t> precision;  // -1 before, 0 exact, 1 after
    std::vector<uint8_t> completes;
    std::vector<int32_t> file_id;
    std::vector<uint64_t> str_off;
    std::vector<uint32_t> str_len;
    std::vector<uint8_t> strbuf;
    size_t size() const { return position.size(); }
};

struct ScanState {
    std::vector<int32_t> leftover;
    bool printed_maybe_cut = false;
    uint64_t consumed;
};

// Align a resumption target to a true event-start position for the
// mission's encoding (used by hot-range window skipping): returns the
// stream offset the event cursor should take so that every event whose
// REPORT can fall at or after `t` is generated.
// Smallest byte value that can appear as a NON-FIRST byte of any event
// for the CJK kinds (conservative per WHATWG trail/continuation ranges:
// euc-kr consumed trails >= 0x41, big5/shift_jis trails >= 0x40,
// euc-jp consumed second/third bytes >= 0x80 (any >= 0x80 byte after a
// lead is consumed, even malformed), gb18030 second bytes are digits
// >= 0x30). Any byte below this can never be spanned by an event, so
// an event starts exactly there ("ground" byte).
static inline uint8_t cjk_ground_limit(int32_t kind) {
    switch (kind) {
        case 4: return 0x41;   // EUC-KR
        case 5: return 0x40;   // Big5
        case 6: return 0x40;   // Shift_JIS
        case 7: return 0x80;   // EUC-JP
        default: return 0x30;  // gb18030/GBK
    }
}

static int64_t align_cursor(const Mission& m, const uint8_t* d, int64_t total,
                            int64_t t, int64_t cur) {
    // Must return a true event-start position <= the first event whose
    // REPORT can fall at or after `t`: an event *spanning* t belongs to
    // the resumed region (its report/label effects land there), so it
    // must be regenerated, never skipped past.
    if (t >= total) return total;
    switch (m.kind) {
        case 0: {  // UTF-8: local claim rule (<=3 bytes lookback)
            if ((d[t] & 0xC0) != 0x80) return t;
            for (int64_t j = 1; j <= 3 && t - j >= 0; j++) {
                uint8_t b = d[t - j];
                if ((b & 0xC0) == 0x80) continue;
                // event length as-if-start at t-j (valid or maximal
                // subpart; pending claims to stream end)
                Event ev;
                int64_t c;
                if (utf8_next(d, total, t - j, &ev)) c = ev.in_len;
                else c = 4;  // pending claims its remaining bytes
                if (t - j + c > t) return t - j;  // spans t: regenerate
                return t;  // unclaimed cont byte: its own malformed start
            }
            return t;  // >=3 preceding cont bytes: t is a start
        }
        case 1:
        case 2: {  // UTF-16: unit containing t + surrogate lookbehind
            // Unit phase comes from the CURSOR (a true event start),
            // not from buffer parity: a streaming chunk buffer can in
            // principle start at an odd stream offset, where buffer-
            // even is stream-odd.
            int64_t ph = cur & 1;
            int64_t u = t - ((t & 1) ^ ph);  // round DOWN to unit start
            if (u >= 2 && u + 1 < total) {
                bool be = m.kind == 2;
                uint32_t prev = be ? (d[u - 2] << 8) | d[u - 1]
                                   : (d[u - 1] << 8) | d[u - 2];
                if (prev >= 0xD800 && prev <= 0xDBFF) return u - 2;
            }
            return u;
        }
        case 4:
        case 5:
        case 6:
        case 7:
        case 8: {
            // CJK multi-byte kinds are not self-synchronizing, so find
            // a provable event start and decode forward: scan back (a
            // bounded window) for a "ground" byte - one that can never
            // be a non-first event byte, hence never spanned - else
            // fall back to the current cursor `cur`, which is a true
            // event start by construction (amortized linear: `cur`
            // only moves forward). Then walk events until the first
            // one whose report lands at or after `t` - exactly the set
            // the resumed window must regenerate (events are
            // partitioned across windows by report).
            const uint8_t lim = cjk_ground_limit(m.kind);
            int64_t g = cur;
            const int64_t back_stop = t - 4096 > cur ? t - 4096 : cur;
            for (int64_t j = t - 1; j >= back_stop; j--) {
                if (d[j] < lim) { g = j; break; }
            }
            int64_t p = g;
            Event e2;
            while (p < total) {
                if (!next_event(m, d, total, p, &e2)) return p;  // pending
                if (e2.report >= t) return e2.pos;
                p = e2.pos + e2.in_len;
            }
            return total;
        }
        default:
            return t;
    }
}

static void scan_mission(const Mission& m, const uint8_t* data, int64_t total,
                         const int64_t* sl_start, const int32_t* sl_len,
                         const int32_t* sl_file, const uint8_t* sl_last,
                         int64_t nslices, Output& out,
                         const int64_t* init_state, int64_t* fini_state,
                         std::vector<int32_t>* init_leftover,
                         std::vector<int32_t>* fini_leftover,
                         const int64_t* hot_start, const int64_t* hot_end,
                         int64_t n_hot,
                         const int64_t* ft_start = nullptr,
                         const int64_t* ft_end = nullptr,
                         const int64_t* ft_co_base = nullptr,
                         const int64_t* ft_co = nullptr,
                         const int64_t* ft_ip = nullptr,
                         const uint8_t* ft_pay = nullptr,
                         int64_t n_ft = 0) {
    ScanState st;
    st.consumed = m.counter_offset;
    int64_t cursor0 = 0;
    if (init_state) {
        st.consumed = (uint64_t)init_state[0];
        cursor0 = init_state[1];
        st.printed_maybe_cut = init_state[2] != 0;
        if (init_leftover) st.leftover = *init_leftover;
    }

    int64_t cursor = cursor0;  // next un-consumed event start position
    Event ev;
    bool ev_ok = false;  // ev holds the next event
    DecState dstate;  // modal decoder carry (ISO-2022-JP mode/flag):
    // part of the resumable state, or segmented scans would reset the
    // mode mid-stream.
    if (init_state) {
        dstate.mode = (int32_t)init_state[3];
        dstate.output_flag = init_state[4] != 0;
    }
    auto advance = [&]() {
        ev_ok = false;
        ev.cp2 = 0;
        if (cursor >= total) return;
        if (m.kind == 9) {
            if (!iso2022_next(m, data, total, &cursor, &dstate, &ev))
                return;  // pending: cursor stays at the partial event
        } else if (!next_event(m, data, total, cursor, &ev)) {
            // Pending event (needs bytes beyond the buffer): LEAVE the
            // cursor at its start. At the true stream end nothing reads
            // it (no flush, encoding_rs parity); for resumable /
            // streaming scans fini_state's cursor marks the partial
            // tail bytes the caller must re-present with the next
            // chunk.
            return;
        }
        ev_ok = true;
    };
    advance();

    std::vector<int32_t> chars, call_chars;
    std::vector<uint8_t> fresh, refpfx;
    chars.reserve(4096);
    call_chars.reserve(4096);
    int64_t hot_cursor = 0;

    // Dense accepted-ASCII fast lane (see the window loop below):
    // eligible for the kinds whose sub-0x80 bytes are always complete
    // 1-byte events decoding to themselves (UTF-8, single-byte tables,
    // and the non-modal CJK kinds - WHATWG maps their ASCII range to
    // identity; UTF-16 units and modal ISO-2022-JP are not byte==cp).
    const bool ascii_fast =
        (m.kind == 0 || m.kind == 3 || (m.kind >= 4 && m.kind <= 8)) &&
        m.grep_char < 0 && m.chars_min_nb <= m.line_max;
    // UTF-16 sibling: a full window is exactly line_max BMP units ->
    // ONE wrapped maybe-cut finding. ubf_acc indexes by the would-be
    // UTF-8 lead byte of the unit (mission.rs:341-348 semantics).
    const bool utf16_fast = (m.kind == 1 || m.kind == 2) &&
                            m.grep_char < 0 && !m.same_block &&
                            m.chars_min_nb <= m.line_max;
    bool ascii_acc[128];
    if (ascii_fast || utf16_fast)
        for (int c = 0; c < 128; c++) ascii_acc[c] = pass_af(m, c);
    // When the accepted-ASCII set is one contiguous range [lo,hi]
    // (true for the default 0x20-0x7E All-Ctrl filter and most
    // aliases), the fast-lane window check runs 8 bytes per step with
    // the hasless/hasmore SWAR range tests (false positives only fall
    // back to the per-byte loop; false negatives are impossible for
    // lo <= 0x7F - the subtraction borrow can only over-flag).
    int32_t acc_lo = 128, acc_hi = -1;
    bool acc_contig = false;
    if (ascii_fast) {
        for (int c = 0; c < 128; c++)
            if (ascii_acc[c]) {
                if (c < acc_lo) acc_lo = c;
                acc_hi = c;
            }
        acc_contig = acc_hi >= acc_lo;
        for (int c = acc_lo; c <= acc_hi && acc_contig; c++)
            if (!ascii_acc[c]) acc_contig = false;
    }
    bool ubf_acc[256];
    std::vector<uint8_t> u16cls;  // unit class for the mixed BMP lane:
                                  // 0 surrogate, 1 valid rejected,
                                  // 2 accepted (one lookup per unit)
    if (utf16_fast) {
        for (int c = 0; c < 256; c++)
            ubf_acc[c] = c >= 0xC0 && pass_ubf(m, c);
        u16cls.resize(65536);
        for (uint32_t u = 0; u < 65536; u++) {
            if (u - 0xD800 < 0x800u) { u16cls[u] = 0; continue; }
            const bool okc = u < 0x80
                ? ascii_acc[u]
                : ubf_acc[u < 0x800 ? (0xC0 | (u >> 6))
                                    : (0xE0 | (u >> 12))];
            u16cls[u] = okc ? 2 : 1;
        }
    }
    // Single-byte full-window accepted lane: for kind 3 every byte is
    // one char, so a full window of table-defined, filter-accepted
    // bytes is exactly two wrapped findings (the ASCII lane's argument
    // without the sub-0x80 restriction); the payload is batch-
    // transcoded through a precomputed per-byte-value UTF-8 table
    // (1-3 bytes each). This is the dense accepted high-byte text
    // shape (e.g. KOI8-R Cyrillic), where the generic walk is slowest.
    // same_block must be off (mixed leads break runs);
    // grep off and chars_min <= line_max as in the sibling lanes.
    const bool sbyte_fast = m.kind == 3 && m.grep_char < 0 &&
                            !m.same_block &&
                            m.chars_min_nb <= m.line_max &&
                            m.table256 != nullptr;
    bool sb_acc[256];
    uint8_t sb_enc[256][3];
    uint8_t sb_len[256];
    if (sbyte_fast) {
        for (int v = 0; v < 256; v++) {
            int32_t cp = m.table256[v];
            bool ok = cp >= 0;
            if (ok)
                ok = cp < 0x80 ? pass_af(m, cp)
                               : pass_ubf(m, utf8_lead_of(cp));
            sb_acc[v] = ok;
            std::vector<uint8_t> tmp;
            if (cp >= 0) utf8_append(tmp, cp);
            sb_len[v] = (uint8_t)tmp.size();
            for (size_t q = 0; q < tmp.size() && q < 3; q++)
                sb_enc[v][q] = tmp[q];
        }
    }
    // Device run-table feed (STRINGSEXT_RUNTABLE_FEED=1; KERNELS.md
    // design 1, the on-device analog of finding_collection.rs:84-342's
    // decode work): ft_* carries EXACT accepted-char runs extracted on
    // device plus the device-decoded UTF-8 payload. Slot layout:
    // run r owns slots [ft_co_base[r], ft_co_base[r+1]) = its chars in
    // order plus one SENTINEL; ft_ip[slot] is the char's input byte
    // offset (sentinel: the run's end byte), ft_co[slot] its offset
    // into ft_pay (sentinel: the run's payload end). ft_pay == data
    // means the payload IS the input span (UTF-8: chars decode to
    // their own bytes), enabling SE_INREF zero-copy emission. Modal
    // ISO-2022-JP (kind 9) works too: a run is byte-contiguous
    // accepted chars, so it never spans an escape - the mode is
    // constant across any in-run window and consuming its chars only
    // clears the output flag (done below); the feed's hot map keeps
    // every mode/phase-dependent byte hot (classify_iso2022.state_hot)
    // so the cold-window skipper stays sound.
    const bool feed_fast = n_ft > 0 && ft_start != nullptr &&
                           ft_co_base != nullptr && ft_co != nullptr &&
                           ft_ip != nullptr &&
                           m.grep_char < 0 && !m.same_block &&
                           m.chars_min_nb <= m.line_max;
    int64_t ft_cursor = 0;

    for (int64_t s = 0; s < nslices; s++) {
        const int64_t sstart = sl_start[s];
        const int32_t slen = sl_len[s];
        const int32_t file_id = sl_file[s];
        const bool is_last = sl_last[s] != 0;
        const int64_t w = 2 * (int64_t)m.line_max;

        bool have_pending = !st.leftover.empty();
        std::vector<int32_t> pending = std::move(st.leftover);
        st.leftover.clear();
        bool flag = st.printed_maybe_cut;

        int64_t label = 0;

        // one decode call
        auto process_call = [&](int64_t call_label, const std::vector<int32_t>& call_chars,
                                bool invalid_after) {
            int8_t precision = 0;  // exact
            if (call_label == 0 && !call_chars.empty()) {
                if (utf8_lead_of(call_chars[0]) >= 0x80) {
                    refpfx.clear();
                    if (have_pending)
                        for (int32_t c : pending) {
                            if (refpfx.size() >= 8) break;
                            utf8_append(refpfx, c);
                        }
                    for (int32_t c : call_chars) {
                        if (refpfx.size() >= 8) break;
                        utf8_append(refpfx, c);
                    }
                    if (refpfx.size() > 8) refpfx.resize(8);
                    fresh_decode_prefix(m, data + sstart, slen, fresh);
                    // The reference compares fresh[0..written] against
                    // its ZERO-INITIALIZED output buffer
                    // (finding_collection.rs:55,183,203-205): main
                    // bytes past the decode read as NUL, so a fresh
                    // decode running ahead into NUL chars still
                    // matches Exact.
                    bool differ = fresh.empty();
                    if (!differ) {
                        size_t cmp = std::min(fresh.size(), refpfx.size());
                        differ = memcmp(refpfx.data(), fresh.data(), cmp) != 0;
                        for (size_t i = cmp; !differ && i < fresh.size(); ++i)
                            differ = fresh[i] != 0;
                    }
                    if (differ) precision = -1;
                }
            }
            // Feed SplitStr from call_chars directly when no leftover
            // needs prepending (the common case) - copying every call
            // into `chars` costs a full extra pass on dense text.
            const int32_t* base;
            int32_t nbase;
            if (have_pending) {
                chars.clear();
                chars.insert(chars.end(), pending.begin(), pending.end());
                precision = -1;
                have_pending = false;
                pending.clear();
                chars.insert(chars.end(), call_chars.begin(), call_chars.end());
                base = chars.data();
                nbase = (int32_t)chars.size();
            } else {
                base = call_chars.data();
                nbase = (int32_t)call_chars.size();
            }

            bool continue_str = flag;
            flag = false;

            SplitStr ss{base, nbase, &m, continue_str, invalid_after};
            Chunk ch;
            while (ss.next(&ch)) {
                if (!ch.filtered_again) {
                    uint64_t off = out.strbuf.size();
                    // Bulk-append: narrow ASCII spans with one resize
                    // (vectorizable), scalar utf8_append otherwise.
                    int32_t i = ch.start;
                    while (i < ch.end) {
                        int32_t j = i;
                        while (j < ch.end && (uint32_t)base[j] < 0x80u) j++;
                        if (j > i) {
                            // insert, not resize+write: resize would
                            // zero-fill the new tail first (a second
                            // full pass over the span)
                            out.strbuf.insert(out.strbuf.end(),
                                              base + i, base + j);
                            i = j;
                        }
                        if (i < ch.end) { utf8_append(out.strbuf, base[i]); i++; }
                    }
                    out.position.push_back(st.consumed + (uint64_t)call_label);
                    out.precision.push_back(precision);
                    out.completes.push_back(ch.completes ? 1 : 0);
                    out.file_id.push_back(file_id);
                    out.str_off.push_back(off);
                    out.str_len.push_back((uint32_t)(out.strbuf.size() - off));
                    pending.clear();
                    have_pending = false;
                    flag = ch.maybe_cut;
                } else {
                    pending.assign(base + ch.start, base + ch.end);
                    have_pending = true;
                    flag = false;
                }
                precision = 1;  // after
            }
        };

        int64_t ws = 0;
        while (ws < slen) {
            int64_t we = ws + w < slen ? ws + w : slen;
            bool last_window = we == slen;

            // Hot-range window skipping (device run tables): a window
            // with no accepted chars, entered with no pending leftover
            // and a clear continuation flag, provably produces no
            // findings and quiesces to the same state - skip it whole.
            // Kind 9 (modal ISO-2022-JP) additionally requires
            // output_flag == false: its cold byte classes are mode- and
            // phase-neutral one-byte events in every mode (see
            // cjk_hot_spec), except that a rejected control decode in
            // ASCII/Roman mode resets output_flag - a no-op only when
            // the flag is already clear.
            // (ev_ok guard: with no decodable event left - pending
            // partial at buffer end - the cursor must stay put so the
            // carry logic sees the partial event's start.)
            if (hot_start != nullptr && ev_ok && !have_pending && !flag &&
                (m.kind != 9 || !dstate.output_flag)) {
                while (hot_cursor < n_hot && hot_end[hot_cursor] <= sstart + ws)
                    hot_cursor++;
                if (hot_cursor == n_hot || hot_start[hot_cursor] >= sstart + we) {
                    if (cursor < sstart + we) {
                        cursor = align_cursor(m, data, total, sstart + we,
                                              cursor);
                        advance();
                    }
                    label = we;
                    ws = we;
                    continue;
                }
            }
            // Accepted-ASCII full-window fast lane: a full 2*line_max
            // window whose bytes are ALL AF-accepted ASCII, entered at
            // an event boundary with no pending leftover, is by
            // SplitStr semantics exactly two line_max-char wrapped
            // findings sharing the window's call label - the first
            // Exact and completing iff the continuation flag was set,
            // the second an After '+' continuation, both maybe-cut
            // (helper.rs:226-237 wrapping + :349-392 flags). Emit them
            // with two strbuf memcpys and skip the whole char
            // materialization + SplitStr walk - the dominant window
            // shape on text-dense input (~3x end-to-end there).
            if (ascii_fast && ev_ok && !have_pending &&
                we - ws == w && cursor == sstart + ws) {
                const uint8_t* p8 = data + sstart + ws;
                int64_t k = 0;
                if (acc_contig) {
                    const uint64_t ones = 0x0101010101010101ull;
                    const uint64_t highs = 0x8080808080808080ull;
                    const uint64_t lo8 = ones * (uint64_t)acc_lo;
                    const uint64_t add = ones * (uint64_t)(127 - acc_hi);
                    while (k + 8 <= w) {
                        uint64_t x;
                        memcpy(&x, p8 + k, 8);
                        if ((((x - lo8) & ~x) | ((x + add) | x)) & highs)
                            break;
                        k += 8;
                    }
                }
                while (k < w && p8[k] < 0x80 && ascii_acc[p8[k]]) k++;
                if (k == w) {
                    const int64_t lm = m.line_max;
                    const uint64_t pos = st.consumed + (uint64_t)label;
                    uint64_t off;
                    if (m.input_refs) {
                        // zero-copy: the finding bytes ARE the input
                        // span; flag the offset instead of copying
                        // (the fused merge reads through inbufs)
                        off = SE_INREF | (uint64_t)(sstart + ws);
                    } else {
                        off = (uint64_t)out.strbuf.size();
                        // insert, not resize+memcpy: resize zero-fills
                        // the new tail first (a second pass per window)
                        out.strbuf.insert(out.strbuf.end(), p8, p8 + w);
                    }
                    out.position.push_back(pos);
                    out.precision.push_back(0);
                    out.completes.push_back(flag ? 1 : 0);
                    out.file_id.push_back(file_id);
                    out.str_off.push_back(off);
                    out.str_len.push_back((uint32_t)lm);
                    out.position.push_back(pos);
                    out.precision.push_back(1);
                    out.completes.push_back(1);
                    out.file_id.push_back(file_id);
                    out.str_off.push_back(off + (uint64_t)lm);
                    out.str_len.push_back((uint32_t)(w - lm));
                    flag = true;
                    cursor = sstart + we;
                    advance();
                    label = we;
                    ws = we;
                    continue;
                }
            }
            // Run-table feed lane: a full window whose chars lie
            // entirely inside ONE device-extracted accepted run has,
            // by SplitStr semantics (helper.rs:226-237 wrapping +
            // :349-392 boundary flags), a closed-form emission shape:
            // its N in-window chars wrap into floor(N/line_max) full
            // findings plus a completing tail, every finding a payload
            // memcpy of device-decoded bytes (no per-char decode +
            // utf8_append). The char walk collapses to two binary
            // searches over the run's slot table. Chars partition into
            // windows by REPORT (= last byte for every feed-eligible
            // char - the builder excludes report-clamped chars), so a
            // char is consumed iff its end slot offset is <= window
            // end. N < line_max with a clear continuation flag would
            // stash a refilter leftover (codepoints the payload does
            // not carry) - that shape falls back to the generic walk.
            // label>0 keeps the first-window Before-precision heuristic
            // on the generic path (finding_collection.rs:155-207).
            if (feed_fast && ev_ok && !have_pending && label > 0 &&
                we - ws == w) {
                while (ft_cursor < n_ft && ft_end[ft_cursor] <= cursor)
                    ft_cursor++;
                const int64_t r = ft_cursor;
                const int64_t swe = sstart + we;
                if (r < n_ft && ft_start[r] <= cursor &&
                    cursor < ft_end[r] && swe <= ft_end[r]) {
                    const int64_t s0 = ft_co_base[r];
                    const int64_t s1 = ft_co_base[r + 1] - 1;  // sentinel
                    // slot of the char starting at `cursor` (a true
                    // event start; if it is not a char start of this
                    // run, bail to the generic walk)
                    const int64_t* lo =
                        std::lower_bound(ft_ip + s0, ft_ip + s1, cursor);
                    if (lo != ft_ip + s1 && *lo == cursor) {
                        const int64_t a = lo - ft_ip;
                        const int64_t u =
                            std::upper_bound(ft_ip + a, ft_ip + s1 + 1,
                                             swe) - ft_ip;
                        const int64_t kend = u - 1;  // one past last char
                        const int64_t N = kend - a;
                        const int64_t lm = m.line_max;
                        if (N > 0 && (N >= lm || flag)) {
                            const uint64_t pos =
                                st.consumed + (uint64_t)label;
                            const bool inref =
                                m.input_refs && ft_pay == data;
                            int64_t cs = a;
                            bool first = true;
                            while (cs < kend) {
                                const int64_t ce =
                                    cs + lm < kend ? cs + lm : kend;
                                const int64_t o0 = ft_co[cs],
                                              o1 = ft_co[ce];
                                uint64_t off;
                                if (inref) {
                                    off = SE_INREF | (uint64_t)o0;
                                } else {
                                    off = (uint64_t)out.strbuf.size();
                                    out.strbuf.insert(out.strbuf.end(),
                                                      ft_pay + o0,
                                                      ft_pay + o1);
                                }
                                out.position.push_back(pos);
                                out.precision.push_back(first ? 0 : 1);
                                out.completes.push_back(
                                    first ? (flag ? 1 : 0) : 1);
                                out.file_id.push_back(file_id);
                                out.str_off.push_back(off);
                                out.str_len.push_back(
                                    (uint32_t)(o1 - o0));
                                first = false;
                                cs = ce;
                            }
                            flag = true;
                            // kind 9: consumed data bytes clear the
                            // modal output flag; the mode itself is
                            // constant inside a run (no escapes).
                            if (m.kind == 9) dstate.output_flag = false;
                            cursor = ft_ip[kend];
                            advance();
                            label = we;
                            ws = we;
                            continue;
                        }
                    }
                }
            }
            // Single-byte full-window accepted lane (see sb_acc/sb_enc
            // above): label>0 keeps the first-window Before heuristic
            // on the generic path, as in the sibling lanes.
            if (sbyte_fast && ev_ok && !have_pending && label > 0 &&
                we - ws == w && cursor == sstart + ws) {
                const uint8_t* p8 = data + sstart + ws;
                int64_t k = 0;
                while (k < w && sb_acc[p8[k]]) k++;
                if (k == w) {
                    const int64_t lm = m.line_max;
                    const uint64_t pos = st.consumed + (uint64_t)label;
                    const size_t base0 = out.strbuf.size();
                    out.strbuf.resize(base0 + (size_t)(3 * w));
                    uint8_t* d0 = out.strbuf.data() + base0;
                    uint8_t* dst = d0;
                    uint32_t len1 = 0;
                    for (int64_t q = 0; q < w; q++) {
                        const uint8_t v = p8[q];
                        // unconditional 3-byte write, advance by the
                        // real length (capacity is 3*w, never exceeded)
                        dst[0] = sb_enc[v][0];
                        dst[1] = sb_enc[v][1];
                        dst[2] = sb_enc[v][2];
                        dst += sb_len[v];
                        if (q == lm - 1)
                            len1 = (uint32_t)(dst - d0);
                    }
                    const uint32_t ltot = (uint32_t)(dst - d0);
                    out.strbuf.resize(base0 + (size_t)ltot);
                    out.position.push_back(pos);
                    out.precision.push_back(0);
                    out.completes.push_back(flag ? 1 : 0);
                    out.file_id.push_back(file_id);
                    out.str_off.push_back((uint64_t)base0);
                    out.str_len.push_back(len1);
                    out.position.push_back(pos);
                    out.precision.push_back(1);
                    out.completes.push_back(1);
                    out.file_id.push_back(file_id);
                    out.str_off.push_back((uint64_t)base0 + len1);
                    out.str_len.push_back(ltot - len1);
                    flag = true;
                    cursor = sstart + we;
                    advance();
                    label = we;
                    ws = we;
                    continue;
                }
            }
            // UTF-16 full-window fast lane: a full window is exactly
            // line_max 2-byte units; if every unit is a non-surrogate
            // accepted BMP char, SplitStr yields ONE wrapped finding
            // covering the whole window (ok_char_nb hits line_max at
            // the window end: maybe-cut, completes iff the flag was
            // set). label>0 keeps the first-window Before-precision
            // heuristic (finding_collection.rs:155-207) on the generic
            // path. Dominant on random/CJK-dense input, where ~96% of
            // unit pairs are valid BMP chars (README.md:30-36).
            if (utf16_fast && ev_ok && !have_pending && label > 0 &&
                we - ws == w && cursor == sstart + ws) {
                const uint8_t* p8 = data + sstart + ws;
                const bool be16 = m.kind == 2;
                int64_t k = 0;
                for (; k < w; k += 2) {
                    uint32_t u = be16
                        ? ((uint32_t)p8[k] << 8) | p8[k + 1]
                        : ((uint32_t)p8[k + 1] << 8) | p8[k];
                    bool okc;
                    if (u < 0x80) okc = ascii_acc[u];
                    else if (u - 0xD800 < 0x800u) okc = false;
                    else
                        okc = ubf_acc[u < 0x800 ? (0xC0 | (u >> 6))
                                                : (0xE0 | (u >> 12))];
                    if (!okc) break;
                }
                if (k == w) {
                    const uint64_t pos = st.consumed + (uint64_t)label;
                    const size_t off = out.strbuf.size();
                    for (int64_t t = 0; t < w; t += 2) {
                        uint32_t u = be16
                            ? ((uint32_t)p8[t] << 8) | p8[t + 1]
                            : ((uint32_t)p8[t + 1] << 8) | p8[t];
                        utf8_append(out.strbuf, (int32_t)u);
                    }
                    out.position.push_back(pos);
                    out.precision.push_back(0);
                    out.completes.push_back(flag ? 1 : 0);
                    out.file_id.push_back(file_id);
                    out.str_off.push_back((uint64_t)off);
                    out.str_len.push_back(
                        (uint32_t)(out.strbuf.size() - off));
                    flag = true;
                    cursor = sstart + we;
                    advance();
                    label = we;
                    ws = we;
                    continue;
                }
            }
            // Mixed ASCII/defined-byte window lane (round-4
            // generalization of the former sub-min lane): a window
            // whose bytes are ALL complete 1-byte chars - sub-0x80
            // for UTF-8 and the CJK kinds, any table-DEFINED byte for
            // single-byte - is ONE call of valid chars with no
            // malformed cut. SplitStr over 1-byte chars specializes
            // to a byte-level walk (helper.rs:206-433 with every char
            // length 1): maximal accepted runs, wrap at line_max, and
            // the exact boundary-flag algebra of helper.rs:349-392,
            // including completes-chains, refilter tail stashes and
            // the stream-end invalid_after dismissal. Entered clean
            // (cursor at window start, no pending leftover) the walk
            // emits the identical findings with no int32 char
            // materialization; UTF-8/CJK ASCII spans are
            // input-identical, so input_refs emits SE_INREF zero-copy
            // spans. Dominant on text windows broken by an occasional
            // rejected byte (the mixed-window shape that previously
            // fell to the generic walk) as well as the old lane's
            // all-sub-min shapes.
            if ((ascii_fast || sbyte_fast) && ev_ok && !have_pending &&
                cursor == sstart + ws) {
                const bool full256 = m.kind == 3 && sbyte_fast;
                const uint8_t* p8 = data + sstart + ws;
                const int64_t wn = we - ws;
                int64_t k = 0;
                if (!full256) {
                    while (k + 8 <= wn) {
                        uint64_t x;
                        memcpy(&x, p8 + k, 8);
                        if (x & 0x8080808080808080ull) break;
                        k += 8;
                    }
                    if (k + 8 > wn)
                        while (k < wn && p8[k] < 0x80) k++;
                } else {
                    while (k < wn && sb_len[p8[k]] != 0) k++;
                }
                if (k == wn) {
                    const bool inv_after = last_window && is_last;
                    const int32_t vmin = m.chars_min_nb;
                    const int64_t lm = m.line_max;
                    int64_t inp_start = 0, p = 0;
                    bool lmc = flag;  // continue_str at call entry
                    flag = false;     // process_call clears; chunks set
                    bool first_chunk = true;
                    for (;;) {
                        int64_t ok_s = p;
                        int64_t ok_nb = 0;
                        while (p < wn && ok_nb < lm) {
                            const uint8_t v = p8[p];
                            if (full256 ? sb_acc[v] : ascii_acc[v]) {
                                ok_nb++; p++;
                                // contiguous-accept burst: extend the
                                // run 8 bytes per step (same SWAR
                                // range test as the full-window lane)
                                if (acc_contig && !full256) {
                                    const uint64_t ones =
                                        0x0101010101010101ull;
                                    const uint64_t highs =
                                        0x8080808080808080ull;
                                    const uint64_t lo8 =
                                        ones * (uint64_t)acc_lo;
                                    const uint64_t add =
                                        ones * (uint64_t)(127 - acc_hi);
                                    while (p + 8 <= wn &&
                                           ok_nb + 8 <= lm) {
                                        uint64_t x;
                                        memcpy(&x, p8 + p, 8);
                                        if ((((x - lo8) & ~x) |
                                             ((x + add) | x)) & highs)
                                            break;
                                        p += 8; ok_nb += 8;
                                    }
                                }
                                continue;
                            }
                            p++;
                            if ((lmc && ok_nb > 0 && ok_s == inp_start) ||
                                ok_nb >= vmin)
                                break;
                            ok_nb = 0; ok_s = p;
                        }
                        if (ok_nb == 0) break;
                        const bool left = ok_s == inp_start;
                        const bool right = ok_s + ok_nb >= wn;
                        const bool mc =
                            ok_nb >= lm || (right && !inv_after);
                        const bool completes = left && lmc;
                        const bool again = !completes && right &&
                                           !inv_after && ok_nb < lm;
                        if (!completes && !again && ok_nb < vmin) break;
                        if (ok_nb >= lm) inp_start = p;
                        lmc = mc;
                        if (!again) {
                            uint64_t off;
                            uint32_t olen;
                            if (full256) {
                                off = (uint64_t)out.strbuf.size();
                                for (int64_t q = 0; q < ok_nb; q++) {
                                    const uint8_t v = p8[ok_s + q];
                                    out.strbuf.push_back(sb_enc[v][0]);
                                    if (sb_len[v] > 1)
                                        out.strbuf.push_back(sb_enc[v][1]);
                                    if (sb_len[v] > 2)
                                        out.strbuf.push_back(sb_enc[v][2]);
                                }
                                olen = (uint32_t)(out.strbuf.size() - off);
                            } else if (m.input_refs) {
                                off = SE_INREF |
                                      (uint64_t)(sstart + ws + ok_s);
                                olen = (uint32_t)ok_nb;
                            } else {
                                off = (uint64_t)out.strbuf.size();
                                out.strbuf.insert(out.strbuf.end(),
                                                  p8 + ok_s,
                                                  p8 + ok_s + ok_nb);
                                olen = (uint32_t)ok_nb;
                            }
                            out.position.push_back(
                                st.consumed + (uint64_t)label);
                            out.precision.push_back(first_chunk ? 0 : 1);
                            out.completes.push_back(completes ? 1 : 0);
                            out.file_id.push_back(file_id);
                            out.str_off.push_back(off);
                            out.str_len.push_back(olen);
                            flag = mc;
                        } else {
                            pending.clear();
                            pending.reserve((size_t)ok_nb);
                            for (int64_t q = 0; q < ok_nb; q++) {
                                const uint8_t v = p8[ok_s + q];
                                pending.push_back(
                                    full256 ? m.table256[v] : (int32_t)v);
                            }
                            have_pending = true;
                            flag = false;
                        }
                        first_chunk = false;
                    }
                    cursor = sstart + we;
                    advance();
                    label = we;
                    ws = we;
                    continue;
                }
            }
            // UTF-16 mixed BMP window lane: the unit-level sibling of
            // the byte lane above. A window of complete NON-SURROGATE
            // units is one call of valid 1-unit chars; the same
            // specialized SplitStr walk applies with accept =
            // AF(unit<0x80) / UBF(would-be UTF-8 lead). Dominant for
            // UTF-16 missions over ASCII-text regions (runs of
            // REJECTED valid BMP chars - e.g. 'th' = U+7468 under the
            // default block filter - that previously walked the
            // generic per-char path). label>0 keeps the first-window
            // Before heuristic generic, as in the sibling lanes.
            if (utf16_fast && ev_ok && !have_pending && label > 0 &&
                cursor == sstart + ws && ((we - ws) & 1) == 0) {
                const uint8_t* p8 = data + sstart + ws;
                const bool be16 = m.kind == 2;
                const int64_t un = (we - ws) >> 1;
                // surrogate precheck, 4 units per 64-bit step: a unit
                // is a surrogate iff (u & 0xF800) == 0xD800, i.e. a
                // 16-bit lane of (x & m16) ^ s16 is zero.
                int64_t k = 0;
                {
                    // LE lane value of a BE unit is lo<<8|hi, so the
                    // surrogate mask sits in the LOW byte there; the
                    // 16-bit haszero detector is endian-agnostic.
                    const uint64_t m16 = be16 ? 0x00F800F800F800F8ull
                                              : 0xF800F800F800F800ull;
                    const uint64_t s16 = be16 ? 0x00D800D800D800D8ull
                                              : 0xD800D800D800D800ull;
                    const uint64_t ones16 = 0x0001000100010001ull;
                    const uint64_t high16 = 0x8000800080008000ull;
                    while (k + 4 <= un) {
                        uint64_t x;
                        memcpy(&x, p8 + 2 * k, 8);
                        const uint64_t y = (x & m16) ^ s16;
                        if ((y - ones16) & ~y & high16) break;
                        k += 4;
                    }
                    for (; k < un; k++) {
                        const uint32_t u = be16
                            ? ((uint32_t)p8[2 * k] << 8) | p8[2 * k + 1]
                            : ((uint32_t)p8[2 * k + 1] << 8) | p8[2 * k];
                        if (u - 0xD800 < 0x800u) break;
                    }
                }
                if (k == un) {
                    const bool inv_after = last_window && is_last;
                    const int32_t vmin = m.chars_min_nb;
                    const int64_t lm = m.line_max;
                    auto unit_at = [&](int64_t q) -> uint32_t {
                        return be16
                            ? ((uint32_t)p8[2 * q] << 8) | p8[2 * q + 1]
                            : ((uint32_t)p8[2 * q + 1] << 8) | p8[2 * q];
                    };
                    int64_t inp_start = 0, p = 0;
                    bool lmc = flag;
                    flag = false;
                    bool first_chunk = true;
                    for (;;) {
                        int64_t ok_s = p;
                        int64_t ok_nb = 0;
                        while (p < un && ok_nb < lm) {
                            if (u16cls[unit_at(p)] == 2) {
                                ok_nb++; p++; continue;
                            }
                            p++;
                            if ((lmc && ok_nb > 0 && ok_s == inp_start) ||
                                ok_nb >= vmin)
                                break;
                            ok_nb = 0; ok_s = p;
                        }
                        if (ok_nb == 0) break;
                        const bool left = ok_s == inp_start;
                        const bool right = ok_s + ok_nb >= un;
                        const bool mc =
                            ok_nb >= lm || (right && !inv_after);
                        const bool completes = left && lmc;
                        const bool again = !completes && right &&
                                           !inv_after && ok_nb < lm;
                        if (!completes && !again && ok_nb < vmin) break;
                        if (ok_nb >= lm) inp_start = p;
                        lmc = mc;
                        if (!again) {
                            const uint64_t off = (uint64_t)out.strbuf.size();
                            for (int64_t q = 0; q < ok_nb; q++)
                                utf8_append(out.strbuf,
                                            (int32_t)unit_at(ok_s + q));
                            out.position.push_back(
                                st.consumed + (uint64_t)label);
                            out.precision.push_back(first_chunk ? 0 : 1);
                            out.completes.push_back(completes ? 1 : 0);
                            out.file_id.push_back(file_id);
                            out.str_off.push_back(off);
                            out.str_len.push_back(
                                (uint32_t)(out.strbuf.size() - off));
                            flag = mc;
                        } else {
                            pending.clear();
                            pending.reserve((size_t)ok_nb);
                            for (int64_t q = 0; q < ok_nb; q++)
                                pending.push_back((int32_t)unit_at(ok_s + q));
                            have_pending = true;
                            flag = false;
                        }
                        first_chunk = false;
                    }
                    cursor = sstart + we;
                    advance();
                    label = we;
                    ws = we;
                    continue;
                }
            }
            for (;;) {
                int64_t call_label = label;
                call_chars.clear();
                bool ended_mal = false;
                Event mal;
                while (ev_ok) {
                    int64_t r = ev.report - sstart;
                    if (r >= we) break;  // belongs to a later window/slice
                    if (ev.cp < 0) {
                        if (!flag &&
                            (int64_t)call_chars.size() +
                                    (have_pending ? (int64_t)pending.size()
                                                  : 0) <
                                (int64_t)m.chars_min_nb) {
                            // With a leftover prepended the combined
                            // walk still can't reach chars_min, and a
                            // malformed cut (invalid_after) dismisses
                            // the right-edge chunk (helper.rs:389-392
                            // needs !invalid_after; completes needs the
                            // flag) - the call's only effect is
                            // clearing the leftover. Dominant on
                            // binary/random input, where window-end
                            // tails chain 1-3-char leftovers and
                            // malformed events cut every few bytes.
                            if (have_pending) {
                                pending.clear();
                                have_pending = false;
                            }
                            // Sterile malformed event: the call it
                            // cuts is shorter than the min finding
                            // length and stateless, so the
                            // process_call below would be skipped and
                            // the round restarted. Inline exactly that
                            // label bookkeeping and keep consuming -
                            // saves the outer-loop round trip per
                            // malformed event (every 2-3 bytes on
                            // machine-code-like inputs).
                            call_chars.clear();
                            int64_t cand = ev.pos + ev.in_len - sstart;
                            if (cand >= label) label = cand;
                            else {
                                int64_t c2 = cand + ev.pushback;
                                if (c2 > label) label = c2;
                            }
                            cursor = ev.pos + ev.in_len;
                            if (m.kind == 0) {
                                // Sterile-call lookahead: consume, in
                                // one tight loop with no Event round
                                // trips, every whole call that is
                                // provably sterile - valid-char runs
                                // whose char count stays below
                                // chars_min before the next malformed
                                // cut (the same rule the inline path
                                // above used for this call). Mirrors
                                // utf8_next's valid/malformed
                                // classification exactly; `run_start`
                                // tracks the current (possibly still
                                // growing) call start, and the loop
                                // exits by rewinding the cursor there,
                                // so a run that might reach chars_min,
                                // cross the window (report
                                // partitioning), or end pending is
                                // re-decoded by the generic path.
                                // Dominant on binary/random input.
                                const int64_t lim2 =
                                    sstart + we < total ? sstart + we
                                                        : total;
                                int64_t run_start = cursor;
                                int32_t vcount = 0;
                                const int32_t vmin = m.chars_min_nb;
                                // Intrinsic 1-byte malformed classes
                                // ([0x80,0xC2) and >= 0xF5): half of
                                // random bytes. Branchless 8-at-a-time
                                // skim (L1 LUT, AND-reduce) before the
                                // per-byte classification.
                                static const auto& cut8 = *[] {
                                    static uint8_t t[256];
                                    for (int v = 0; v < 256; v++)
                                        t[v] = (v >= 0x80 && v < 0xC2) ||
                                               v >= 0xF5;
                                    return &t;
                                }();
                                while (cursor < lim2) {
                                    uint8_t b2 = data[cursor];
                                    if ((b2 >= 0x80 && b2 < 0xC2) ||
                                        b2 >= 0xF5) {
                                        // intrinsic 1-byte malformed
                                        // (report = pos): cuts the
                                        // sterile call
                                        cursor++;
                                        while (cursor < lim2 &&
                                               cut8[data[cursor]])
                                            cursor++;
                                        run_start = cursor;
                                        vcount = 0;
                                        continue;
                                    }
                                    int32_t L;
                                    bool valid;
                                    if (b2 < 0x80) {
                                        L = 1;
                                        valid = true;
                                    } else if (b2 <= 0xDF) {
                                        if (cursor + 1 >= total) break;
                                        if ((data[cursor + 1] & 0xC0) ==
                                            0x80) {
                                            L = 2; valid = true;
                                        } else {
                                            L = 1; valid = false;
                                        }
                                    } else if (b2 <= 0xEF) {
                                        if (cursor + 1 >= total) break;
                                        uint8_t t1 = data[cursor + 1];
                                        bool c1ok =
                                            (t1 & 0xC0) == 0x80 &&
                                            !(b2 == 0xE0 && t1 < 0xA0) &&
                                            !(b2 == 0xED && t1 > 0x9F);
                                        if (!c1ok) {
                                            L = 1; valid = false;
                                        } else if (cursor + 2 >= total) {
                                            break;
                                        } else if ((data[cursor + 2] &
                                                    0xC0) == 0x80) {
                                            L = 3; valid = true;
                                        } else {
                                            L = 2; valid = false;
                                        }
                                    } else {
                                        if (cursor + 1 >= total) break;
                                        uint8_t t1 = data[cursor + 1];
                                        bool c1ok =
                                            (t1 & 0xC0) == 0x80 &&
                                            !(b2 == 0xF0 && t1 < 0x90) &&
                                            !(b2 == 0xF4 && t1 > 0x8F);
                                        if (!c1ok) {
                                            L = 1; valid = false;
                                        } else if (cursor + 2 >= total) {
                                            break;
                                        } else if ((data[cursor + 2] &
                                                    0xC0) != 0x80) {
                                            L = 2; valid = false;
                                        } else if (cursor + 3 >= total) {
                                            break;
                                        } else if ((data[cursor + 3] &
                                                    0xC0) == 0x80) {
                                            L = 4; valid = true;
                                        } else {
                                            L = 3; valid = false;
                                        }
                                    }
                                    if (valid) {
                                        // a run reaching chars_min may
                                        // emit: rewind and re-decode
                                        if (vcount + 1 >= vmin) break;
                                        // report = pos+L-1 must stay
                                        // inside this window
                                        if (cursor + L > lim2) break;
                                        vcount++;
                                        cursor += L;
                                    } else {
                                        // malformed report = pos+L:
                                        // only consume while it stays
                                        // inside this window
                                        if (cursor + L >= lim2) break;
                                        cursor += L;
                                        run_start = cursor;
                                        vcount = 0;
                                    }
                                }
                                cursor = run_start;
                                int64_t cand2 = cursor - sstart;
                                if (cand2 > label) label = cand2;
                            }
                            call_label = label;
                            advance();
                            continue;
                        }
                        mal = ev;
                        // Consume the malformed bytes; for the UTF-16
                        // lone-high case the lookahead unit starts at
                        // pos+in_len and is re-classified by advance()
                        // (the pushback re-decode).
                        cursor = ev.pos + ev.in_len;
                        advance();
                        ended_mal = true;
                        break;
                    }
                    call_chars.push_back(ev.cp);
                    if (ev.cp2) call_chars.push_back(ev.cp2);
                    cursor = ev.pos + ev.in_len;
                    // Batch runs of 1-byte events without the Event
                    // round trip (their report == pos, so the window
                    // partition test is just cursor < window end):
                    // UTF-8 / CJK ASCII bytes, and defined single-byte
                    // table entries. Span-first + bulk widen: find the
                    // span end (8-byte SWAR for the ASCII case), then
                    // one resize + a widening loop the compiler
                    // vectorizes - per-element push_back measured ~5x
                    // slower on dense text.
                    {
                        const int64_t lim =
                            sstart + we < total ? sstart + we : total;
                        // (kind 9, modal ISO-2022-JP, never batches:
                        // sub-0x80 bytes there are mode-dependent)
                        if (m.kind == 0 || (m.kind >= 4 && m.kind <= 8)) {
                            // Short probe (random data: spans of 1-3
                            // bytes, push_back wins), then SWAR span +
                            // one bulk widen for real text runs.
                            while (cursor < lim && data[cursor] < 0x80) {
                                call_chars.push_back(data[cursor++]);
                                if (((cursor ^ (cursor - 1)) & 7) == 7 &&
                                    cursor + 8 <= lim) {
                                    int64_t e = cursor;
                                    while (e + 8 <= lim) {
                                        uint64_t wd;
                                        memcpy(&wd, data + e, 8);
                                        if (wd & 0x8080808080808080ull)
                                            break;
                                        e += 8;
                                    }
                                    while (e < lim && data[e] < 0x80) e++;
                                    if (e > cursor) {
                                        size_t old = call_chars.size();
                                        call_chars.resize(
                                            old + (size_t)(e - cursor));
                                        int32_t* dst =
                                            call_chars.data() + old;
                                        const uint8_t* src = data + cursor;
                                        for (int64_t i = 0; i < e - cursor;
                                             i++)
                                            dst[i] = src[i];
                                        cursor = e;
                                    }
                                    break;
                                }
                            }
                        } else if (m.kind == 3) {
                            int32_t c;
                            while (cursor < lim &&
                                   (c = m.table256[data[cursor]]) >= 0) {
                                call_chars.push_back(c);
                                cursor++;
                            }
                        } else if (m.kind == 1 || m.kind == 2) {
                            // UTF-16 BMP batch: any unit outside the
                            // surrogate range is a complete 1-unit
                            // char (report == its second byte, still
                            // inside the window iff unit end <= lim).
                            const bool be16 = m.kind == 2;
                            while (cursor + 2 <= lim) {
                                uint32_t u = be16
                                    ? ((uint32_t)data[cursor] << 8) |
                                          data[cursor + 1]
                                    : ((uint32_t)data[cursor + 1] << 8) |
                                          data[cursor];
                                if (u - 0xD800 < 0x800u) break;
                                call_chars.push_back((int32_t)u);
                                cursor += 2;
                            }
                        }
                    }
                    advance();
                }
                bool invalid_after = ended_mal || (last_window && is_last);
                // Sterile-call fast path: a call shorter than the
                // min finding length, entered with no pending leftover
                // and a clear continuation flag, and cut by a
                // malformed event (invalid_after dismisses any tail
                // chunk) can neither emit a finding nor change state -
                // skip the SplitStr walk. Dominant on malformed-dense
                // (machine-code-like) inputs, where decode calls split
                // every few bytes. An EMPTY stateless call is likewise
                // a provable no-op whatever cut it.
                bool noop_call = call_chars.empty() && !have_pending && !flag;
                // Same sterile rule as the inline malformed path above:
                // a malformed-cut call whose chars (leftover included)
                // can't reach chars_min only clears the leftover.
                bool sterile_mal =
                    ended_mal && !flag &&
                    (int64_t)call_chars.size() +
                            (have_pending ? (int64_t)pending.size() : 0) <
                        (int64_t)m.chars_min_nb;
                if (sterile_mal && have_pending) {
                    pending.clear();
                    have_pending = false;
                }
                if (!noop_call && !sterile_mal)
                    process_call(call_label, call_chars, invalid_after);
                if (!ended_mal) break;
                int64_t cand = mal.pos + mal.in_len - sstart;
                if (cand >= label) label = cand;
                else {
                    int64_t c2 = cand + mal.pushback;
                    label = label > c2 ? label : c2;
                }
            }
            label = we;
            ws = we;
        }

        if (is_last && slen > 0 && (have_pending || flag)) {
            // (with no pending leftover and a clear flag the flush
            // call is a no-op - see noop_call above)
            call_chars.clear();
            process_call(label, call_chars, true);
        }

        st.leftover = std::move(pending);
        st.printed_maybe_cut = flag;
        st.consumed += (uint64_t)slen;
    }

    if (fini_state) {
        fini_state[0] = (int64_t)st.consumed;
        fini_state[1] = cursor;
        fini_state[2] = st.printed_maybe_cut ? 1 : 0;
        fini_state[3] = dstate.mode;
        fini_state[4] = dstate.output_flag ? 1 : 0;
    }
    if (fini_leftover) *fini_leftover = st.leftover;
}

}  // namespace

extern "C" {

// Resumable scan state (checkpoint/resume and chunked streaming)
// mirrors ScannerState (scanner.rs:40-68) and travels as the raw
// int64[5] state_io buffer documented on se_scan below, plus the
// leftover_io codepoint array.
struct se_mission {
    uint64_t af_lo, af_hi;
    uint64_t ubf;
    int32_t grep_char;
    int32_t chars_min_nb;
    int32_t line_max;
    int32_t same_block;
    uint64_t counter_offset;
    int32_t kind;
    const int32_t* table256;
    const int32_t* pair_cp;
    const int32_t* pair_cp2;
    const int64_t* gb_ptrs;
    const int32_t* gb_cps;
    int32_t gb_nranges;
    const int32_t* multi_keys;
    const int32_t* multi_cp1;
    const int32_t* multi_cp2;
    int32_t n_multi;
    int32_t input_refs;
};

// Scans one mission over the sliced stream. Returns an opaque handle
// (free with se_free); result arrays are exposed via the out-params and
// stay valid until the handle is freed. Struct-of-arrays for clean
// numpy interop.
// state_io: NULL, or int64[5] {consumed, cursor, printed_flag,
// dec_mode, dec_output_flag} used as initial state and overwritten
// with the final state (the last two carry the modal ISO-2022-JP
// decoder). leftover_io / leftover_len_io likewise carry the leftover
// codepoints (capacity leftover_cap).
void* se_scan(const uint8_t* data, int64_t total,
              const int64_t* slice_starts, const int32_t* slice_lens,
              const int32_t* slice_file_ids, const uint8_t* slice_is_last,
              int64_t nslices, const se_mission* sm,
              int64_t* state_io, int32_t* leftover_io, int32_t* leftover_len_io,
              int32_t leftover_cap,
              const int64_t* hot_start, const int64_t* hot_end, int64_t n_hot,
              const int64_t* ft_start, const int64_t* ft_end,
              const int64_t* ft_co_base, const int64_t* ft_co,
              const int64_t* ft_ip, const uint8_t* ft_pay, int64_t n_ft,
              int64_t* out_count,
              const uint64_t** out_position, const int8_t** out_precision,
              const uint8_t** out_completes, const int32_t** out_file_id,
              const uint64_t** out_str_off, const uint32_t** out_str_len,
              const uint8_t** out_strbuf, int64_t* out_strbuf_len) {
    Mission m;
    m.af_lo = sm->af_lo; m.af_hi = sm->af_hi; m.ubf = sm->ubf;
    m.grep_char = sm->grep_char; m.chars_min_nb = sm->chars_min_nb;
    m.line_max = sm->line_max; m.same_block = sm->same_block;
    m.counter_offset = sm->counter_offset; m.kind = sm->kind;
    m.table256 = sm->table256;
    m.pair_cp = sm->pair_cp; m.pair_cp2 = sm->pair_cp2;
    m.gb_ptrs = sm->gb_ptrs; m.gb_cps = sm->gb_cps;
    m.gb_nranges = sm->gb_nranges;
    m.multi_keys = sm->multi_keys; m.multi_cp1 = sm->multi_cp1;
    m.multi_cp2 = sm->multi_cp2; m.n_multi = sm->n_multi;
    m.input_refs = sm->input_refs;

    std::vector<int32_t> lo_in, lo_out;
    if (state_io && leftover_io && leftover_len_io && *leftover_len_io > 0)
        lo_in.assign(leftover_io, leftover_io + *leftover_len_io);

    Output* out = new Output();
    scan_mission(m, data, total, slice_starts, slice_lens, slice_file_ids,
                 slice_is_last, nslices, *out,
                 state_io, state_io,
                 state_io ? &lo_in : nullptr,
                 state_io ? &lo_out : nullptr,
                 hot_start, hot_end, n_hot,
                 ft_start, ft_end, ft_co_base, ft_co, ft_ip, ft_pay, n_ft);
    if (state_io && leftover_io && leftover_len_io) {
        int32_t n = (int32_t)lo_out.size();
        if (n > leftover_cap) n = leftover_cap;
        for (int32_t i = 0; i < n; i++) leftover_io[i] = lo_out[i];
        *leftover_len_io = n;
    }

    *out_count = (int64_t)out->size();
    *out_position = out->position.data();
    *out_precision = out->precision.data();
    *out_completes = out->completes.data();
    *out_file_id = out->file_id.data();
    *out_str_off = out->str_off.data();
    *out_str_len = out->str_len.data();
    *out_strbuf = out->strbuf.data();
    *out_strbuf_len = (int64_t)out->strbuf.size();
    return out;
}

void se_free(void* handle) { delete (Output*)handle; }

// One finding line (finding.rs:112-155 grammar): "\n" + [file id
// letter+space] + [precision mark + radix position + "+\t"/" \t"] +
// ["(a ENC)\t"] + UTF-8 string bytes. Caller guarantees >= 28 +
// enc_pref_len + slen bytes of room at `w`.
static inline uint8_t* se_write_line(
    uint8_t* w, bool show_file, bool show_radix, bool show_enc,
    bool no_meta, char radix, uint64_t position, int8_t precision,
    uint8_t completes, int32_t file_id, int32_t mi,
    const uint8_t* enc_prefix, const int32_t* enc_pref_off,
    const int32_t* enc_pref_len, const uint8_t* sptr, uint32_t slen) {
    *w++ = '\n';
    if (!no_meta) {
        if (show_file && file_id >= 0) {
            *w++ = (uint8_t)(file_id + 64);
            *w++ = ' ';
        }
        if (show_radix) {
            *w++ = precision > 0 ? '>' : (precision < 0 ? '<' : ' ');
            // Branch-free-ish radix conversion (snprintf per finding
            // measured ~4x the whole loop's budget).
            unsigned long long v = position;
            char tmp[24];
            int k = 0;
            if (radix == 'x') {
                do { unsigned d = (unsigned)(v & 15);
                     tmp[k++] = (char)(d < 10 ? '0' + d : 'a' + d - 10);
                     v >>= 4; } while (v);
            } else if (radix == 'o') {
                do { tmp[k++] = (char)('0' + (v & 7)); v >>= 3; } while (v);
            } else {
                do { tmp[k++] = (char)('0' + (v % 10)); v /= 10; } while (v);
            }
            while (k) *w++ = (uint8_t)tmp[--k];
            *w++ = completes ? '+' : ' ';
            *w++ = '\t';
        }
        if (show_enc) {
            memcpy(w, enc_prefix + enc_pref_off[mi], enc_pref_len[mi]);
            w += enc_pref_len[mi];
        }
    }
    memcpy(w, sptr, slen);
    return w + slen;
}

// Worst-case per-line bytes BEFORE the enc prefix and string payload,
// derived field by field from se_write_line: '\n' (1) + file letter
// and space (2) + precision mark (1) + position digits (<= 22 octal
// digits for a max uint64) + '+'/' ' (1) + '\t' (1) = 28. Any new
// metadata field must be added HERE, not to a bare constant at a use
// site; the slack absorbs an off-by-a-couple until then.
static constexpr size_t SE_LINE_META_MAX = 1 + 2 + 1 + 22 + 1 + 1;
static constexpr size_t SE_LINE_HEADROOM = SE_LINE_META_MAX + 4;

// Merge-ordered output formatting (finding.rs:112-155 grammar): the
// caller pre-gathers every finding column into merge order (numpy
// fancy-indexing, vectorized) and this writes the byte-exact lines.
// The BOM and the final "\n" stay with the caller. Returns a malloc'd
// buffer via out_buf/out_len; free the returned handle with
// se_format_free (the Python side copies once via ctypes.string_at -
// the buffer itself is never duplicated here).
static void* se_format_impl(int64_t n, const uint64_t* position,
               const int8_t* precision,
               const uint8_t* completes, const int32_t* file_id,
               const int32_t* midx, const uint64_t* str_off,
               const uint32_t* str_len, const uint8_t* const* strbufs,
               const uint8_t* enc_prefix, const int32_t* enc_pref_off,
               const int32_t* enc_pref_len, int32_t flags, char radix,
               uint8_t** out_buf, int64_t* out_len) {
    const bool show_file = flags & 1, show_radix = flags & 2,
               show_enc = flags & 4, no_meta = flags & 8;
    uint64_t total_s = 0;
    int32_t max_pref = 0;
    for (int64_t i = 0; i < n; i++) total_s += str_len[i];
    if (show_enc) {
        // midx values index enc_pref_len densely from 0; n>0 implies
        // at least one mission.
        int32_t n_miss = 0;
        for (int64_t i = 0; i < n; i++)
            if (midx[i] >= n_miss) n_miss = midx[i] + 1;
        for (int32_t k = 0; k < n_miss; k++)
            if (enc_pref_len[k] > max_pref) max_pref = enc_pref_len[k];
    }
    // Exact upper bound per line: SE_LINE_META_MAX + enc prefix +
    // string bytes.
    // malloc, not a vector: resize() would memset the whole worst-case
    // buffer (an extra full memory pass) before the loop rewrites it.
    uint64_t cap = total_s
        + (uint64_t)n * (SE_LINE_META_MAX + (uint64_t)max_pref) + 64;
    uint8_t* base = (uint8_t*)malloc(cap);
    if (!base) { *out_buf = nullptr; *out_len = 0; return nullptr; }
    uint8_t* w = base;
    for (int64_t i = 0; i < n; i++) {
        int32_t mi = midx[i];
        w = se_write_line(w, show_file, show_radix, show_enc, no_meta,
                          radix, position[i], precision[i], completes[i],
                          file_id[i], mi, enc_prefix, enc_pref_off,
                          enc_pref_len, strbufs[mi] + str_off[i],
                          str_len[i]);
    }
    static uint8_t empty = 0;
    *out_buf = w == base ? &empty : base;
    *out_len = (int64_t)(w - base);
    return base;
}

void* se_format(int64_t n, const uint64_t* position, const int8_t* precision,
               const uint8_t* completes, const int32_t* file_id,
               const int32_t* midx, const uint64_t* str_off,
               const uint32_t* str_len, const uint8_t* const* strbufs,
               const uint8_t* enc_prefix, const int32_t* enc_pref_off,
               const int32_t* enc_pref_len, int32_t flags, char radix,
               uint8_t** out_buf, int64_t* out_len) {
    return se_format_impl(n, position, precision, completes, file_id, midx,
                          str_off, str_len, strbufs, enc_prefix, enc_pref_off,
                          enc_pref_len, flags, radix, out_buf, out_len);
}

// Same formatting, but the payload is written straight to `fd`
// (looping over short writes) and freed here - no Python bytes copy
// and no BufferedWriter copy for forensic-scale outputs. Returns bytes
// written, or -1 on malloc/write failure (errno holds the write
// error).
int64_t se_format_fd(int32_t fd, int64_t n, const uint64_t* position,
               const int8_t* precision,
               const uint8_t* completes, const int32_t* file_id,
               const int32_t* midx, const uint64_t* str_off,
               const uint32_t* str_len, const uint8_t* const* strbufs,
               const uint8_t* enc_prefix, const int32_t* enc_pref_off,
               const int32_t* enc_pref_len, int32_t flags, char radix) {
    uint8_t* buf = nullptr;
    int64_t len = 0;
    void* h = se_format_impl(n, position, precision, completes, file_id,
                             midx, str_off, str_len, strbufs, enc_prefix,
                             enc_pref_off, enc_pref_len, flags, radix,
                             &buf, &len);
    if (!h && len == 0 && n > 0 && !buf) return -1;  // malloc failure
    int64_t done = 0;
    while (done < len) {
        ssize_t k = write(fd, buf + done, (size_t)(len - done));
        if (k < 0) {
            if (errno == EINTR) continue;
            free(h);
            return -1;
        }
        done += k;
    }
    free(h);
    return done;
}

void se_format_free(void* handle) { free(handle); }

// Fused k-way merge + format + write: merges per-stream finding
// columns by the reference merge key (position, mission_id;
// finding.rs:92-109 - ids are unique per mission so the ubf/!af
// tie-breaks can never engage across streams), formats each line, and
// writes straight to `fd` from a bounded buffer - no lexsort, no
// gathers, no Python-side payload. Streams must be position-sorted
// (scan order); ties on the full key across streams resolve to the
// LOWEST stream index, matching the stable lexsort over concatenated
// columns (the streaming path passes held-back boundary findings as
// earlier streams). enc prefix tables are indexed BY STREAM. Returns
// bytes written, -1 on malloc/write failure.
int64_t se_merge_fd(int32_t fd, int32_t k, const int64_t* n_m,
    const uint64_t* const* pos_m, const int8_t* const* prec_m,
    const uint8_t* const* comp_m, const int32_t* const* fid_m,
    const uint64_t* const* soff_m, const uint32_t* const* slen_m,
    const uint8_t* const* strbufs, const uint8_t* const* inbufs,
    const int32_t* mission_ids,
    const uint8_t* enc_prefix, const int32_t* enc_pref_off,
    const int32_t* enc_pref_len, int32_t flags, char radix) {
    const bool show_file = flags & 1, show_radix = flags & 2,
               show_enc = flags & 4, no_meta = flags & 8;
    size_t cap = 4u << 20;
    uint8_t* buf = (uint8_t*)malloc(cap);
    if (!buf) return -1;
    std::vector<int64_t> c(k, 0);
    uint8_t* w = buf;
    int64_t total = 0;
    auto flush = [&]() -> bool {
        int64_t len = (int64_t)(w - buf), done = 0;
        while (done < len) {
            ssize_t r = write(fd, buf + done, (size_t)(len - done));
            if (r < 0) {
                if (errno == EINTR) continue;
                return false;
            }
            done += r;
        }
        total += len;
        w = buf;
        return true;
    };
    for (;;) {
        int32_t best = -1;
        uint64_t bpos = 0;
        int32_t bmid = 0;
        for (int32_t j = 0; j < k; j++) {
            if (c[j] >= n_m[j]) continue;
            uint64_t pj = pos_m[j][c[j]];
            if (best < 0 || pj < bpos ||
                (pj == bpos && mission_ids[j] < bmid)) {
                best = j;
                bpos = pj;
                bmid = mission_ids[j];
            }
        }
        if (best < 0) break;
        const int64_t i = c[best]++;
        const uint32_t sl = slen_m[best][i];
        size_t need = SE_LINE_HEADROOM
            + (size_t)(show_enc ? enc_pref_len[best] : 0) + sl;
        if ((size_t)(w - buf) + need > cap) {
            if (!flush()) { free(buf); return -1; }
            if (need > cap) {  // pathological single line > buffer
                uint8_t* nb = (uint8_t*)realloc(buf, need);
                if (!nb) { free(buf); return -1; }
                buf = nb;
                cap = need;
                w = buf;
            }
        }
        const uint64_t so = soff_m[best][i];
        const uint8_t* sptr = (so & SE_INREF)
            ? inbufs[best] + (so & ~SE_INREF)
            : strbufs[best] + so;
        w = se_write_line(w, show_file, show_radix, show_enc, no_meta,
                          radix, bpos, prec_m[best][i], comp_m[best][i],
                          fid_m[best][i], best, enc_prefix, enc_pref_off,
                          enc_pref_len, sptr, sl);
    }
    if (!flush()) { free(buf); return -1; }
    free(buf);
    return total;
}

// Slab variant of the fused merge: renders rows [c0[j], c1[j]) of each
// stream into a caller-sized malloc'd buffer instead of an fd. The
// caller partitions the merged stream BY POSITION RANGE (the merge key
// is position-major, so slabs are independent) and renders slabs on
// all cores concurrently, writing them to the output in order - the
// parallel analog of the reference's single merger thread
// (main.rs:103-136). `cap` must be an upper bound on the slab's output
// bytes (the Python side computes it exactly from SE_LINE_META_MAX +
// prefix + payload sums). Returns bytes rendered, -1 on malloc
// failure; free *out_buf with se_format_free.
int64_t se_merge_buf(int32_t k, const int64_t* c0, const int64_t* c1,
    const uint64_t* const* pos_m, const int8_t* const* prec_m,
    const uint8_t* const* comp_m, const int32_t* const* fid_m,
    const uint64_t* const* soff_m, const uint32_t* const* slen_m,
    const uint8_t* const* strbufs, const uint8_t* const* inbufs,
    const int32_t* mission_ids,
    const uint8_t* enc_prefix, const int32_t* enc_pref_off,
    const int32_t* enc_pref_len, int32_t flags, char radix,
    int64_t cap, uint8_t** out_buf) {
    const bool show_file = flags & 1, show_radix = flags & 2,
               show_enc = flags & 4, no_meta = flags & 8;
    uint8_t* buf = (uint8_t*)malloc(cap < 64 ? 64 : (size_t)cap);
    if (!buf) { *out_buf = nullptr; return -1; }
    std::vector<int64_t> c(c0, c0 + k);
    uint8_t* w = buf;
    for (;;) {
        int32_t best = -1;
        uint64_t bpos = 0;
        int32_t bmid = 0;
        for (int32_t j = 0; j < k; j++) {
            if (c[j] >= c1[j]) continue;
            uint64_t pj = pos_m[j][c[j]];
            if (best < 0 || pj < bpos ||
                (pj == bpos && mission_ids[j] < bmid)) {
                best = j;
                bpos = pj;
                bmid = mission_ids[j];
            }
        }
        if (best < 0) break;
        const int64_t i = c[best]++;
        const uint64_t so = soff_m[best][i];
        const uint8_t* sptr = (so & SE_INREF)
            ? inbufs[best] + (so & ~SE_INREF)
            : strbufs[best] + so;
        w = se_write_line(w, show_file, show_radix, show_enc, no_meta,
                          radix, bpos, prec_m[best][i], comp_m[best][i],
                          fid_m[best][i], best, enc_prefix, enc_pref_off,
                          enc_pref_len, sptr, slen_m[best][i]);
    }
    *out_buf = buf;
    return (int64_t)(w - buf);
}

}  // extern "C"
