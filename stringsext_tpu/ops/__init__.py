"""Device compute path: data-parallel scan passes in JAX, compiled by XLA.

This package is the data-parallel replacement for the reference's hot
loops (the encoding_rs byte DFA at finding_collection.rs:139 and the
SplitStr per-char walk at helper.rs:237-332):

- classify*.py:     per-byte validity/decode lanes (jnp, jittable)
- runs.py:          mission filter masks + accepted-run compaction (jnp)
- swar.py:          fused 4-bytes-per-word mission scan + block counts
- specs.py:         static mission specs for swar.py (jax-free)
- device_events.py: exact decode-event generation on device
"""
