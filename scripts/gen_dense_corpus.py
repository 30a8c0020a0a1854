#!/usr/bin/env python3
"""Canonical dense-benchmark corpus generator.

Reproducible recipe for the "text-dense mix" end-to-end benchmark: a
forensic-style image where EVERY 512-byte block is hot (so device hot
maps cannot skip anything and the host emitter does full exact work):

  - ~60% ASCII text in paragraph-scale runs (200-2000 bytes),
  - ~20% UTF-16LE-encoded text strings (100-400 bytes),
  - ~20% binary gaps of uniform random bytes (50-300 bytes).

Usage: python scripts/gen_dense_corpus.py OUT_FILE SIZE_BYTES [SEED]

The composition mirrors what embedded documents + wide-string tables +
machine code look like in disk images; "dense" here means the finding
density stays high everywhere (output volume is comparable to input
volume), which is the worst case for the emit path - sparse images are
covered by the hot-map skip machinery instead.
"""
import sys

import numpy as np

WORDS = (
    "the quick brown fox jumps over lazy dog alpha beta gamma delta "
    "synergy pipeline kernel throughput vector string extraction unicode "
    "forensic image carving analysis evidence artifact timeline memory "
    "process registry network packet session token header payload index"
).split()


def generate(size: int, seed: int = 7) -> bytes:
    rng = np.random.default_rng(seed)
    words = [w.encode() for w in WORDS]
    parts = []
    total = 0
    while total < size:
        r = rng.random()
        if r < 0.60:
            n_words = int(rng.integers(30, 300))
            s = b" ".join(rng.choice(words, size=n_words)) + b". "
        elif r < 0.80:
            n_words = int(rng.integers(15, 60))
            t = " ".join(str(w, "ascii") for w in rng.choice(words, size=n_words))
            s = t.encode("utf-16le")
        else:
            n = int(rng.integers(50, 300))
            s = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        parts.append(s)
        total += len(s)
    return b"".join(parts)[:size]


def main() -> int:
    out = sys.argv[1]
    size = int(sys.argv[2])
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 7
    with open(out, "wb") as f:
        f.write(generate(size, seed))
    print(f"wrote {size} bytes to {out} (seed {seed})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
