"""Fidelity tests for the vendored WHATWG index corpus.

The decode tables are the correctness foundation of 38/41 encodings
(the reference gets them from encoding_rs, which compiles in the
WHATWG indexes: /root/reference/src/mission.rs:681, scanner.rs:76).
This suite pins the vendored corpus (whatwg_data.npz) against Python's
codecs with an EXPLICIT expected-divergence list per encoding — every
difference is an audited, documented WHATWG-vs-vendor-codec deviation,
so any drift (a regenerated table, a typo'd override, a codec change)
fails loudly and points at the exact byte.
"""

import json
import os

import numpy as np
import pytest

from stringsext_tpu.encodings import ALL_ENCODING_NAMES, encoding_kind
from stringsext_tpu.encodings import whatwg

HERE = os.path.dirname(os.path.abspath(__file__))
AUDIT = os.path.join(
    HERE, "..", "stringsext_tpu", "encodings", "whatwg_audit.json")

SB_CODECS = {
    "IBM866": "cp866", "ISO-8859-2": "iso8859_2", "ISO-8859-3": "iso8859_3",
    "ISO-8859-4": "iso8859_4", "ISO-8859-5": "iso8859_5",
    "ISO-8859-6": "iso8859_6", "ISO-8859-7": "iso8859_7",
    "ISO-8859-8": "iso8859_8", "ISO-8859-8-I": "iso8859_8",
    "ISO-8859-10": "iso8859_10", "ISO-8859-13": "iso8859_13",
    "ISO-8859-14": "iso8859_14", "ISO-8859-15": "iso8859_15",
    "ISO-8859-16": "iso8859_16", "KOI8-R": "koi8_r", "KOI8-U": "koi8_u",
    "macintosh": "mac_roman", "windows-874": "cp874",
    "windows-1250": "cp1250", "windows-1251": "cp1251",
    "windows-1252": "cp1252", "windows-1253": "cp1253",
    "windows-1254": "cp1254", "windows-1255": "cp1255",
    "windows-1256": "cp1256", "windows-1257": "cp1257",
    "windows-1258": "cp1258", "x-mac-cyrillic": "mac_cyrillic",
}

# byte -> (python_value_or_None, whatwg_value): the complete audited
# divergence set between the WHATWG single-byte indexes and Python's
# codecs. C1 = WHATWG maps the byte to the C1 control of its own value
# where the Windows codepage leaves a hole.
C1 = "c1"
SB_EXPECTED_DIFFS = {
    "windows-874": {b: C1 for b in
                    [0x81, 0x82, 0x83, 0x84, 0x86, 0x87, 0x88, 0x89, 0x8A,
                     0x8B, 0x8C, 0x8D, 0x8E, 0x8F, 0x90, 0x98, 0x99, 0x9A,
                     0x9B, 0x9C, 0x9D, 0x9E, 0x9F]},
    "windows-1250": {b: C1 for b in [0x81, 0x83, 0x88, 0x90, 0x98]},
    "windows-1251": {0x98: C1},
    "windows-1252": {b: C1 for b in [0x81, 0x8D, 0x8F, 0x90, 0x9D]},
    "windows-1253": {b: C1 for b in
                     [0x81, 0x88, 0x8A, 0x8C, 0x8D, 0x8E, 0x8F, 0x90, 0x98,
                      0x9A, 0x9C, 0x9D, 0x9E, 0x9F]},
    "windows-1254": {b: C1 for b in
                     [0x81, 0x8D, 0x8E, 0x8F, 0x90, 0x9D, 0x9E]},
    "windows-1255": {
        **{b: C1 for b in [0x81, 0x8A, 0x8C, 0x8D, 0x8E, 0x8F, 0x90, 0x9A,
                           0x9C, 0x9D, 0x9E, 0x9F]},
        0xCA: (None, 0x05BA)},
    "windows-1257": {b: C1 for b in
                     [0x81, 0x83, 0x88, 0x8A, 0x8C, 0x90, 0x98, 0x9A, 0x9C,
                      0x9F]},
    "windows-1258": {b: C1 for b in
                     [0x81, 0x8A, 0x8D, 0x8E, 0x8F, 0x90, 0x9A, 0x9D, 0x9E]},
    "KOI8-U": {0xAE: (0x255D, 0x045E), 0xBE: (0x256C, 0x040E)},
    "macintosh": {0xBD: (0x03A9, 0x2126)},
}


@pytest.mark.parametrize("name", sorted(SB_CODECS))
def test_single_byte_vs_python(name):
    codec = SB_CODECS[name]
    table = whatwg.single_byte(name)
    expected = SB_EXPECTED_DIFFS.get(name, {})
    seen = {}
    for b in range(0x80, 0x100):
        try:
            ch = bytes([b]).decode(codec)
            py = ord(ch) if len(ch) == 1 else None
        except UnicodeDecodeError:
            py = None
        w = int(table[b - 0x80])
        w = w if w >= 0 else None
        if py != w:
            seen[b] = (py, w)
    norm_expected = {
        b: ((None, b) if v == C1 else v) for b, v in expected.items()
    }
    assert seen == norm_expected, (
        f"{name}: unaudited divergence(s) "
        f"{ {hex(k): v for k, v in seen.items() if k not in norm_expected} }"
    )


def test_single_byte_all_encodings_have_tables():
    from stringsext_tpu.encodings import single_byte_table

    for name in ALL_ENCODING_NAMES:
        if encoding_kind(name) == "single-byte":
            t = single_byte_table(name)
            assert t.shape == (128,)
            # every single-byte table must map at least half the range
            # (the sparsest, ISO-8859-6, maps 83/128)
            assert (t >= 0).sum() >= 64 or name == "x-user-defined"


def test_x_user_defined():
    from stringsext_tpu.encodings import single_byte_table

    t = single_byte_table("x-user-defined")
    assert (t == 0xF780 + np.arange(128)).all()  # WHATWG 14.5


# --- jis0208 structure (shared by Shift_JIS / EUC-JP / ISO-2022-JP) ---

def test_jis0208_structure():
    idx = whatwg.jis0208()
    assert idx.shape == (11280,)
    assert int((idx >= 0).sum()) == 7724  # cp932 layout total
    # EUDC pointers are null in the index (decoder formula area).
    assert (idx[8836:10716] == -1).all()
    # NEC-selected IBM rows duplicate the IBM extension area as a set.
    nec = {int(v) for v in idx[8272:8648] if v >= 0}
    ibm = {int(v) for v in idx[10716:] if v >= 0}
    assert nec <= ibm and len(nec) == 374 and len(ibm) == 388


def test_jis0208_windows_symbol_mappings():
    """WHATWG index jis0208 uses the Windows mappings for the famous
    row-1/2 symbols, not the strict JIS X 0208 ones."""
    pt = whatwg.pair_cp("euc-jp")
    assert pt[0xA1, 0xC1] == 0xFF5E  # FULLWIDTH TILDE, not WAVE DASH
    assert pt[0xA1, 0xC2] == 0x2225  # PARALLEL TO, not DOUBLE VERT LINE
    assert pt[0xA1, 0xDD] == 0xFF0D  # FULLWIDTH HYPHEN-MINUS, not MINUS
    assert pt[0xA1, 0xF1] == 0xFFE0  # FULLWIDTH CENT SIGN
    assert pt[0xA1, 0xF2] == 0xFFE1  # FULLWIDTH POUND SIGN
    assert pt[0xA2, 0xCC] == 0xFFE2  # FULLWIDTH NOT SIGN


def test_jis0208_nec_rows_decode():
    """NEC row 13 and the IBM extensions decode (strict JIS rejects
    them; encoding_rs accepts them — WHATWG index jis0208)."""
    pt = whatwg.pair_cp("euc-jp")
    assert pt[0xAD, 0xA1] == 0x2460  # CIRCLED DIGIT ONE (NEC row 13)
    sj = whatwg.pair_cp("shift_jis")
    assert sj[0x87, 0x40] == 0x2460  # same char via Shift_JIS
    assert sj[0xFA, 0x40] == 0x2170  # SMALL ROMAN NUMERAL ONE (IBM ext)
    # EUDC formula area
    assert sj[0xF0, 0x40] == 0xE000
    assert sj[0xF9, 0xFC] == 0xE757


def test_shift_jis_vs_cp932_exhaustive():
    """The Shift_JIS pair table equals cp932 on every two-byte
    sequence (WHATWG adopted the Windows codepage-932 layout)."""
    pt = whatwg.pair_cp("shift_jis")
    diffs = []
    for lead in list(range(0x81, 0xA0)) + list(range(0xE0, 0xFD)):
        for trail in [t for t in range(0x40, 0xFD) if t != 0x7F]:
            try:
                s = bytes([lead, trail]).decode("cp932")
                py = ord(s) if len(s) == 1 else None
            except UnicodeDecodeError:
                py = None
            w = int(pt[lead, trail])
            w = w if w >= 0 else None
            if py != w:
                diffs.append((hex(lead), hex(trail), py, w))
    assert diffs == []


def test_euc_jp_vs_python_audited():
    """EUC-JP two-byte: diffs vs Python's strict-JIS codec are exactly
    the Windows symbol row-1/2 mappings + NEC row 13 + NEC-selected
    IBM rows 89-92 (where Python errors and WHATWG decodes)."""
    pt = whatwg.pair_cp("euc-jp")
    bad = []
    for lead in range(0xA1, 0xFF):
        for trail in range(0xA1, 0xFF):
            try:
                s = bytes([lead, trail]).decode("euc_jp")
                py = ord(s) if len(s) == 1 else None
            except UnicodeDecodeError:
                py = None
            w = int(pt[lead, trail])
            w = w if w >= 0 else None
            if py == w:
                continue
            row = lead - 0xA0
            if row in (13, 89, 90, 91, 92) and py is None and w is not None:
                continue  # NEC/IBM rows: WHATWG-only
            if row in (1, 2) and py is not None and w is not None:
                continue  # Windows symbol variants (pinned above)
            bad.append((hex(lead), hex(trail), py, w))
    assert bad == []


def test_euc_kr_vs_cp949_exhaustive():
    pt = whatwg.pair_cp("euc-kr")
    diffs = []
    for lead in range(0x81, 0xFF):
        for trail in range(0x41, 0xFF):
            try:
                s = bytes([lead, trail]).decode("cp949")
                py = ord(s) if len(s) == 1 else None
            except UnicodeDecodeError:
                py = None
            w = int(pt[lead, trail])
            w = w if w >= 0 else None
            if py != w:
                diffs.append((hex(lead), hex(trail), py, w))
    assert diffs == []
    assert int((pt >= 0).sum()) == 17048  # windows-949 total


def test_big5_vs_python_audited():
    """Big5: the vendored index is HKSCS-2008 (WHATWG's source
    revision); Python's big5hkscs is HKSCS-2004. Expected diffs:
    additions (py None) and the seven classic Big5 duplicate symbols
    HKSCS-2008 withdrew."""
    WITHDRAWN = {(0xA1, 0x5A), (0xA1, 0xC3), (0xA1, 0xC5), (0xA1, 0xFE),
                 (0xA2, 0x40), (0xA2, 0xCC), (0xA2, 0xCE)}
    pt = whatwg.pair_cp("big5")
    multi = whatwg.pair_multi("big5")
    bad = []
    n_added = 0
    for lead in range(0x81, 0xFF):
        for trail in list(range(0x40, 0x7F)) + list(range(0xA1, 0xFF)):
            try:
                s = bytes([lead, trail]).decode("big5hkscs")
                py = tuple(ord(c) for c in s)
            except UnicodeDecodeError:
                py = None
            key = lead * 256 + trail
            if key in multi:
                w = multi[key]
            else:
                v = int(pt[lead, trail])
                w = (v,) if v >= 0 else None
            if py == w:
                continue
            if py is None and w is not None:
                n_added += 1  # HKSCS-2008 addition
                continue
            if (lead, trail) in WITHDRAWN and w is None:
                continue
            bad.append((hex(lead), hex(trail), py, w))
    assert bad == []
    assert n_added == 68
    assert len(multi) == 4
    assert multi[0x8862] == (0x00CA, 0x0304)
    assert multi[0x8864] == (0x00CA, 0x030C)
    assert multi[0x88A3] == (0x00EA, 0x0304)
    assert multi[0x88A5] == (0x00EA, 0x030C)


GB2_EXPECTED = {
    # GB18030-2005 BMP remappings WHATWG adopted (Python is 2000):
    (0xA6, 0xD9): 0xFE10, (0xA6, 0xDA): 0xFE12, (0xA6, 0xDB): 0xFE11,
    (0xA6, 0xDC): 0xFE13, (0xA6, 0xDD): 0xFE14, (0xA6, 0xDE): 0xFE15,
    (0xA6, 0xDF): 0xFE16, (0xA6, 0xEC): 0xFE17, (0xA6, 0xED): 0xFE18,
    (0xA6, 0xF3): 0xFE19,
    (0xA8, 0xBC): 0x1E3F,
    (0xFE, 0x59): 0x9FB4, (0xFE, 0x61): 0x9FB5, (0xFE, 0x66): 0x9FB6,
    (0xFE, 0x67): 0x9FB7, (0xFE, 0x6D): 0x9FB8, (0xFE, 0x7E): 0x9FB9,
    (0xFE, 0x90): 0x9FBA, (0xFE, 0xA0): 0x9FBB,
    # spec-level web-compat override:
    (0xA3, 0xA0): 0x3000,
}


def test_gb18030_two_byte_vs_python_audited():
    pt = whatwg.pair_cp("gb18030")
    bad = []
    for lead in range(0x81, 0xFF):
        for trail in [t for t in range(0x40, 0xFF) if t != 0x7F]:
            try:
                s = bytes([lead, trail]).decode("gb18030")
                py = ord(s) if len(s) == 1 else None
            except UnicodeDecodeError:
                py = None
            w = int(pt[lead, trail])
            w = w if w >= 0 else None
            if py == w:
                continue
            if GB2_EXPECTED.get((lead, trail)) == w:
                continue
            bad.append((hex(lead), hex(trail), py, w))
    assert bad == []
    # Total mapping: every well-formed two-byte form decodes.
    n_valid = 126 * 190
    assert int((pt >= 0).sum()) == n_valid


def test_gb18030_ranges():
    ptrs, cps = whatwg.gb18030_ranges()
    # Spec special case: pointer 7457 is U+E7C7.
    assert whatwg.gb18030_range_decode(7457) == 0xE7C7
    # 2000-ranges linearity kept where GB18030-2005 withdrew 4-byte
    # forms (U+9FB4.., U+FE10..): WHATWG still decodes them.
    assert whatwg.gb18030_range_decode(19057) == 0x9FB4
    assert whatwg.gb18030_range_decode(39076) == 0xFE10
    # Boundaries.
    assert whatwg.gb18030_range_decode(0) == 0x0080
    assert whatwg.gb18030_range_decode(39419) == 0xFFFF
    assert whatwg.gb18030_range_decode(189000) == 0x10000
    assert whatwg.gb18030_range_decode(1237575) == 0x10FFFF
    # Exhaustive vs Python (GB18030-2000) outside the one special case.
    for p in [1, 7456, 7458, 10000, 20000, 30000, 39418]:
        b1 = 0x81 + p // 12600
        r = p % 12600
        seq = bytes([b1, 0x30 + r // 1260, 0x81 + r % 1260 // 10,
                     0x30 + r % 10])
        assert whatwg.gb18030_range_decode(p) == ord(seq.decode("gb18030"))


def test_gb18030_ranges_full_python_diff():
    """Every 4-byte BMP pointer matches Python's GB18030-2000 codec
    except pointer 7457 (the audited U+E7C7 special case)."""
    ptrs, cps = whatwg.gb18030_ranges()
    bmp = ptrs[ptrs < 189000]
    # check every breakpoint and its predecessor/successor
    checks = set()
    for p in bmp.tolist():
        checks.update({p, p - 1, p + 1})
    checks = sorted(c for c in checks if 0 <= c <= 39419)
    for p in checks:
        b1 = 0x81 + p // 12600
        r = p % 12600
        seq = bytes([b1, 0x30 + r // 1260, 0x81 + r % 1260 // 10,
                     0x30 + r % 10])
        py = ord(seq.decode("gb18030"))
        w = whatwg.gb18030_range_decode(p)
        if p == 7457:
            assert (py, w) == (0x1E3F, 0xE7C7)
        else:
            assert py == w, (p, hex(py), hex(w))


def test_jis0212_total():
    t = whatwg.jis0212_cp()
    assert int((t >= 0).sum()) == 6067  # JIS X 0212 character count
    # spot checks vs Python (same source table)
    assert int(t[0xA2, 0xAF]) == ord(b"\x8f\xa2\xaf".decode("euc_jp"))


def test_audit_file_consistency():
    """The checked-in audit JSON matches the checked-in tables (no
    stale regeneration)."""
    with open(AUDIT) as f:
        audit = json.load(f)
    assert audit["sources"]["jis0208"]["nonnull"] == 7724
    assert audit["sources"]["euc-kr"]["nonnull"] == 17048
    assert audit["sources"]["jis0212"]["nonnull"] == 6067
    assert audit["diffs"]["EUC-KR_py_vs_glibc"] == []
    ov = {o["pointer"]: o["whatwg"] for o in audit["overrides"]["gb18030"]}
    assert ov == {6555: 0x3000}


# Exact per-table glibc-arbitration diff counts (round 3: every
# single-byte table + jis0212 second-sourced against glibc iconv; every
# divergence classified as C1 fill, documented index override, or an
# audited glibc-only variant). A regenerated audit that drifts from
# these counts means a source changed underneath us - fail loudly.
GLIBC_DIFF_COUNTS = {
    "IBM866": 0, "ISO-8859-2": 0, "ISO-8859-3": 0, "ISO-8859-4": 0,
    "ISO-8859-5": 0, "ISO-8859-6": 0, "ISO-8859-7": 0, "ISO-8859-8": 0,
    "ISO-8859-10": 0, "ISO-8859-13": 0, "ISO-8859-14": 0,
    "ISO-8859-15": 0, "ISO-8859-16": 0, "KOI8-R": 0, "KOI8-U": 2,
    "macintosh": 3, "windows-874": 23, "windows-1250": 5,
    "windows-1251": 1, "windows-1252": 5, "windows-1253": 14,
    "windows-1254": 7, "windows-1255": 13, "windows-1256": 0,
    "windows-1257": 10, "windows-1258": 9, "x-mac-cyrillic": 1,
}


def test_single_byte_glibc_arbitration_pinned():
    """Every single-byte table has a recorded glibc second-source pass
    with the exact audited diff set: zero diffs (two sources agree on
    all 128 entries) or classified entries only."""
    with open(AUDIT) as f:
        audit = json.load(f)
    for name, count in GLIBC_DIFF_COUNTS.items():
        d = audit["diffs"][f"{name}_vs_glibc"]
        assert d["count"] == count, (name, d["count"], count)
        assert len(d["entries"]) == count
        for e in d["entries"]:
            assert e.get("why"), (name, e)
    # ISO-8859-8-I is a copy of ISO-8859-8 (WHATWG 9), checked directly
    assert np.array_equal(whatwg.single_byte("ISO-8859-8-I"),
                          whatwg.single_byte("ISO-8859-8"))


def test_jis0212_glibc_arbitration_pinned():
    """jis0212's strict glibc pass has exactly one audited divergence:
    pointer 116 (0x8F 0xA2 0xB7), where glibc alone says U+FF5E and
    four independent sources (Python euc_jp / euc_jisx0213 /
    iso2022_jp_2 and Tcl's Unicode-consortium-derived jis0212.enc)
    say U+007E - the table keeps U+007E."""
    with open(AUDIT) as f:
        audit = json.load(f)
    d = audit["diffs"]["jis0212_vs_glibc"]
    assert d["count"] == 1
    e = d["entries"][0]
    assert e["pointer"] == 116 and e["table"] == 0x7E
    assert e["glibc"] == 0xFF5E and e["why"]
    assert int(whatwg.jis0212_cp()[0xA2, 0xB7]) == 0x7E


def test_tables_load_thread_safe():
    """The per-mission scan threads look tables up concurrently on
    first use: the tables are read eagerly (a shared lazy NpzFile
    handle corrupted concurrent reads), and concurrent first lookups
    all see the same tables."""
    import threading

    whatwg._data.cache_clear()
    whatwg.single_byte.cache_clear()
    names = ["KOI8-R", "windows-1252", "IBM866", "ISO-8859-7",
             "macintosh", "x-mac-cyrillic", "windows-874", "ISO-8859-2"]
    errors, got = [], {}

    def lookup(name):
        try:
            got[name] = whatwg.single_byte(name).copy()
            whatwg.pair_cp("big5")
        except Exception as e:  # pragma: no cover - the regression
            errors.append(e)

    threads = [threading.Thread(target=lookup, args=(n,))
               for n in names * 4]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert isinstance(whatwg._data(), dict)
    whatwg.single_byte.cache_clear()
    for n in names:
        np.testing.assert_array_equal(got[n], whatwg.single_byte(n))
