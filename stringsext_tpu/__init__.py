"""stringsext-tpu: a data-parallel string-extraction framework.

A ground-up reimplementation of the capabilities of `stringsext`
(reference: /root/reference, a Rust CLI) designed for an accelerator:

- The hot byte-scanning path (validity DFA, filter masks, run detection)
  runs as data-parallel JAX/XLA passes over large device-resident byte
  buffers (`stringsext_tpu.ops`).
- Multi-device scaling shards the byte stream over a `jax.sharding.Mesh`
  with halo overlap (`stringsext_tpu.parallel`) instead of the
  reference's one-thread-per-encoding model.
- A thin, exact "emission automaton" (`stringsext_tpu.engine`) replays the
  reference's observable chunking semantics (4 KiB slices, 2*q-byte decode
  windows, leftover carry, precision heuristics) over the compacted
  device results, so output is bit-identical with the reference CLI.

Layer map (mirrors SURVEY.md section 1):
  L5 CLI/UX        -> cli.py, help.py, options.py
  L4 Mission cfg   -> mission.py
  L3 Orchestration -> engine/scanner.py, merge in output.py
  L2 Scan engine   -> engine/automaton.py + ops/* kernels
  L1 Input/Output  -> input.py, finding.py
  decode engine    -> encodings/* (replaces the encoding_rs crate)
"""

__version__ = "0.2.0"
AUTHOR = "stringsext-tpu authors"


def version_line() -> str:
    """The -V output (shared by the fast CLI path and help.py so
    the two can never diverge; deliberately jax/numpy-free)."""
    return f"Version {__version__}, {AUTHOR}"
