"""WHATWG encoding registry: label resolution and decode tables.

This package replaces the reference's external native dependency
`encoding_rs` (SURVEY.md component #10; used via `Encoding::for_label`
at /root/reference/src/mission.rs:681 and
`new_decoder_without_bom_handling` at /root/reference/src/scanner.rs:76).

Instead of a streaming state-machine decoder, this framework decodes
via data-parallel classification passes (see `stringsext_tpu.ops` and
`stringsext_tpu.engine.events`); this module provides the static data
those passes need:

- `encoding_for_label(label)`: WHATWG label -> canonical encoding name.
- `single_byte_table(name)`: 128-entry codepoint table for the
  single-byte encodings (built from Python's codecs, which implement the
  same windows/ISO index tables).
- Encoding-kind helpers used to pick the right classification kernel.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np

# Canonical encoding names, as listed by `--list-encodings`
# (/root/reference/src/help.rs:54-96).
ALL_ENCODING_NAMES = [
    "Big5",
    "EUC-JP",
    "EUC-KR",
    "GBK",
    "IBM866",
    "ISO-2022-JP",
    "ISO-8859-10",
    "ISO-8859-13",
    "ISO-8859-14",
    "ISO-8859-15",
    "ISO-8859-16",
    "ISO-8859-2",
    "ISO-8859-3",
    "ISO-8859-4",
    "ISO-8859-5",
    "ISO-8859-6",
    "ISO-8859-7",
    "ISO-8859-8",
    "ISO-8859-8-I",
    "KOI8-R",
    "KOI8-U",
    "Shift_JIS",
    "UTF-16BE",
    "UTF-16LE",
    "UTF-8",
    "gb18030",
    "macintosh",
    "replacement",
    "windows-1250",
    "windows-1251",
    "windows-1252",
    "windows-1253",
    "windows-1254",
    "windows-1255",
    "windows-1256",
    "windows-1257",
    "windows-1258",
    "windows-874",
    "x-mac-cyrillic",
    "x-user-defined",
]

# WHATWG Encoding Standard label table (section 4.2 "Names and labels").
_LABELS: Dict[str, List[str]] = {
    "UTF-8": [
        "unicode-1-1-utf-8", "unicode11utf8", "unicode20utf8", "utf-8",
        "utf8", "x-unicode20utf8",
    ],
    "IBM866": ["866", "cp866", "csibm866", "ibm866"],
    "ISO-8859-2": [
        "csisolatin2", "iso-8859-2", "iso-ir-101", "iso8859-2", "iso88592",
        "iso_8859-2", "iso_8859-2:1987", "l2", "latin2",
    ],
    "ISO-8859-3": [
        "csisolatin3", "iso-8859-3", "iso-ir-109", "iso8859-3", "iso88593",
        "iso_8859-3", "iso_8859-3:1988", "l3", "latin3",
    ],
    "ISO-8859-4": [
        "csisolatin4", "iso-8859-4", "iso-ir-110", "iso8859-4", "iso88594",
        "iso_8859-4", "iso_8859-4:1988", "l4", "latin4",
    ],
    "ISO-8859-5": [
        "csisolatincyrillic", "cyrillic", "iso-8859-5", "iso-ir-144",
        "iso8859-5", "iso88595", "iso_8859-5", "iso_8859-5:1988",
    ],
    "ISO-8859-6": [
        "arabic", "asmo-708", "csiso88596e", "csiso88596i",
        "csisolatinarabic", "ecma-114", "iso-8859-6", "iso-8859-6-e",
        "iso-8859-6-i", "iso-ir-127", "iso8859-6", "iso88596", "iso_8859-6",
        "iso_8859-6:1987",
    ],
    "ISO-8859-7": [
        "csisolatingreek", "ecma-118", "elot_928", "greek", "greek8",
        "iso-8859-7", "iso-ir-126", "iso8859-7", "iso88597", "iso_8859-7",
        "iso_8859-7:1987", "sun_eu_greek",
    ],
    "ISO-8859-8": [
        "csiso88598e", "csisolatinhebrew", "hebrew", "iso-8859-8",
        "iso-8859-8-e", "iso-ir-138", "iso8859-8", "iso88598", "iso_8859-8",
        "iso_8859-8:1988", "visual",
    ],
    "ISO-8859-8-I": ["csiso88598i", "iso-8859-8-i", "logical"],
    "ISO-8859-10": [
        "csisolatin6", "iso-8859-10", "iso-ir-157", "iso8859-10",
        "iso885910", "l6", "latin6",
    ],
    "ISO-8859-13": ["iso-8859-13", "iso8859-13", "iso885913"],
    "ISO-8859-14": ["iso-8859-14", "iso8859-14", "iso885914"],
    "ISO-8859-15": [
        "csisolatin9", "iso-8859-15", "iso8859-15", "iso885915",
        "iso_8859-15", "l9",
    ],
    "ISO-8859-16": ["iso-8859-16"],
    "KOI8-R": ["cskoi8r", "koi", "koi8", "koi8-r", "koi8_r"],
    "KOI8-U": ["koi8-ru", "koi8-u"],
    "macintosh": ["csmacintosh", "mac", "macintosh", "x-mac-roman"],
    "windows-874": [
        "dos-874", "iso-8859-11", "iso8859-11", "iso885911", "tis-620",
        "windows-874",
    ],
    "windows-1250": ["cp1250", "windows-1250", "x-cp1250"],
    "windows-1251": ["cp1251", "windows-1251", "x-cp1251"],
    "windows-1252": [
        "ansi_x3.4-1968", "ascii", "cp1252", "cp819", "csisolatin1",
        "ibm819", "iso-8859-1", "iso-ir-100", "iso8859-1", "iso88591",
        "iso_8859-1", "iso_8859-1:1987", "l1", "latin1", "us-ascii",
        "windows-1252", "x-cp1252",
    ],
    "windows-1253": ["cp1253", "windows-1253", "x-cp1253"],
    "windows-1254": [
        "cp1254", "csisolatin5", "iso-8859-9", "iso-ir-148", "iso8859-9",
        "iso88599", "iso_8859-9", "iso_8859-9:1989", "l5", "latin5",
        "windows-1254", "x-cp1254",
    ],
    "windows-1255": ["cp1255", "windows-1255", "x-cp1255"],
    "windows-1256": ["cp1256", "windows-1256", "x-cp1256"],
    "windows-1257": ["cp1257", "windows-1257", "x-cp1257"],
    "windows-1258": ["cp1258", "windows-1258", "x-cp1258"],
    "x-mac-cyrillic": ["x-mac-cyrillic", "x-mac-ukrainian"],
    "GBK": [
        "chinese", "csgb2312", "csiso58gb231280", "gb2312", "gb_2312",
        "gb_2312-80", "gbk", "iso-ir-58", "x-gbk",
    ],
    "gb18030": ["gb18030"],
    "Big5": ["big5", "big5-hkscs", "cn-big5", "csbig5", "x-x-big5"],
    "EUC-JP": ["cseucpkdfmtjapanese", "euc-jp", "x-euc-jp"],
    "ISO-2022-JP": ["csiso2022jp", "iso-2022-jp"],
    "Shift_JIS": [
        "csshiftjis", "ms932", "ms_kanji", "shift-jis", "shift_jis", "sjis",
        "windows-31j", "x-sjis",
    ],
    "EUC-KR": [
        "cseuckr", "csksc56011987", "euc-kr", "iso-ir-149", "korean",
        "ks_c_5601-1987", "ks_c_5601-1989", "ksc5601", "ksc_5601",
        "windows-949",
    ],
    "UTF-16BE": ["unicodefffe", "utf-16be"],
    "UTF-16LE": [
        "csunicode", "iso-10646-ucs-2", "ucs-2", "unicode", "unicodefeff",
        "utf-16", "utf-16le",
    ],
    "x-user-defined": ["x-user-defined"],
    "replacement": [
        "csiso2022kr", "hz-gb-2312", "iso-2022-cn", "iso-2022-cn-ext",
        "iso-2022-kr", "replacement",
    ],
}

_LABEL_TO_NAME: Dict[str, str] = {}
for _name, _labels in _LABELS.items():
    for _l in _labels:
        _LABEL_TO_NAME[_l] = _name

# ASCII whitespace stripped by `Encoding::for_label` per WHATWG.
_ASCII_WS = "\t\n\x0c\r "


def encoding_for_label(label: str) -> Optional[str]:
    """WHATWG `get an encoding` / encoding_rs `Encoding::for_label`
    (used at mission.rs:681): strip ASCII whitespace, lowercase ASCII,
    look up the label table. Returns the canonical name or None."""
    t = label.strip(_ASCII_WS)
    t = "".join(chr(ord(c) + 32) if "A" <= c <= "Z" else c for c in t)
    return _LABEL_TO_NAME.get(t)


# --- Encoding kinds, used to select the classification kernel.
KIND_UTF8 = "utf8"
KIND_UTF16LE = "utf16le"
KIND_UTF16BE = "utf16be"
KIND_SINGLE_BYTE = "single-byte"
KIND_BIG5 = "big5"
KIND_EUC_JP = "euc-jp"
KIND_EUC_KR = "euc-kr"
KIND_GB18030 = "gb18030"  # also GBK: WHATWG GBK's decoder == gb18030's
KIND_SHIFT_JIS = "shift_jis"
KIND_ISO_2022_JP = "iso-2022-jp"
KIND_REPLACEMENT = "replacement"

_SINGLE_BYTE_CODECS: Dict[str, str] = {
    "IBM866": "cp866",
    "ISO-8859-2": "iso8859_2",
    "ISO-8859-3": "iso8859_3",
    "ISO-8859-4": "iso8859_4",
    "ISO-8859-5": "iso8859_5",
    "ISO-8859-6": "iso8859_6",
    "ISO-8859-7": "iso8859_7",
    "ISO-8859-8": "iso8859_8",
    "ISO-8859-8-I": "iso8859_8",
    "ISO-8859-10": "iso8859_10",
    "ISO-8859-13": "iso8859_13",
    "ISO-8859-14": "iso8859_14",
    "ISO-8859-15": "iso8859_15",
    "ISO-8859-16": "iso8859_16",
    "KOI8-R": "koi8_r",
    "KOI8-U": "koi8_u",
    "macintosh": "mac_roman",
    "windows-874": "cp874",
    "windows-1250": "cp1250",
    "windows-1251": "cp1251",
    "windows-1252": "cp1252",
    "windows-1253": "cp1253",
    "windows-1254": "cp1254",
    "windows-1255": "cp1255",
    "windows-1256": "cp1256",
    "windows-1257": "cp1257",
    "windows-1258": "cp1258",
    "x-mac-cyrillic": "mac_cyrillic",
}


def encoding_kind(name: str) -> str:
    """Map a canonical encoding name to its decoder kind."""
    if name == "UTF-8":
        return KIND_UTF8
    if name == "UTF-16LE":
        return KIND_UTF16LE
    if name == "UTF-16BE":
        return KIND_UTF16BE
    if name in _SINGLE_BYTE_CODECS or name == "x-user-defined":
        return KIND_SINGLE_BYTE
    if name == "Big5":
        return KIND_BIG5
    if name == "EUC-JP":
        return KIND_EUC_JP
    if name == "EUC-KR":
        return KIND_EUC_KR
    if name in ("GBK", "gb18030"):
        return KIND_GB18030
    if name == "Shift_JIS":
        return KIND_SHIFT_JIS
    if name == "ISO-2022-JP":
        return KIND_ISO_2022_JP
    if name == "replacement":
        return KIND_REPLACEMENT
    raise KeyError(f"unknown encoding: {name}")


@functools.lru_cache(maxsize=None)
def single_byte_table(name: str) -> np.ndarray:
    """128-entry int32 table: byte 0x80+i -> Unicode codepoint, or -1 if
    the byte is undefined (malformed) in this encoding.

    Loaded from the vendored WHATWG index corpus (see
    `stringsext_tpu.encodings.whatwg`); x-user-defined maps
    0x80+i -> U+F780+i (WHATWG 14.5; the reference relies on this for
    ASCII emulation, mission.rs:623-679).
    """
    if name == "x-user-defined":
        return 0xF780 + np.arange(128, dtype=np.int32)
    from . import whatwg

    return whatwg.single_byte(name).copy()


@functools.lru_cache(maxsize=None)
def full_byte_table(name: str) -> np.ndarray:
    """256-entry codepoint table (identity for 0x00-0x7F)."""
    out = np.arange(256, dtype=np.int32)
    out[128:] = single_byte_table(name)
    return out
