"""The no-jax invariant: DEFAULT host scan paths never import jax.

cli.py promises "jax is imported by NO scan path"; the .deb depends
only on python3 + numpy. A hermetic subprocess poisons the jax import
(find_spec MetaPathFinder), runs the buffered AND streaming default
paths with probe segmentation forced on (the round-5 regression
surface: _mission_cold_lut and _cjk_boundary_aligned used to pull
ops.swar / parallel.distributed, both jax-importers at module
level), and asserts findings came out with jax never loaded.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys, importlib.abc
class Poison(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError(f"jax poisoned ({name})")
sys.meta_path.insert(0, Poison())
assert "jax" not in sys.modules, "jax preloaded - test env not hermetic"
sys.path.insert(0, %(repo)r)
import io, os
os.environ["STRINGSEXT_DEVICE_PROBE"] = "0"
import numpy as np
from stringsext_tpu.cli import parse_args
from stringsext_tpu.mission import Missions
from stringsext_tpu.run import run, _run_streaming_stdin
import stringsext_tpu.run as R
R._SEGMENT_PROBE_MIN = 1
R._SEGMENT_MAX = 4
rng = np.random.default_rng(1)
blob = bytearray(rng.integers(0, 256, 2 << 20, np.uint8).tobytes())
blob[1 << 19 : (1 << 19) + 200000] = b"\x00" * 200000
blob[(1 << 19) + 100 : (1 << 19) + 117] = b"no-jax finding 1!"
import tempfile
p = tempfile.NamedTemporaryFile(delete=False)
p.write(bytes(blob)); p.close()
buf = io.BytesIO()
rc = run(parse_args(["-t", "x", "-u", "Asian", "-e", "UTF-8",
                     "-e", "shift_jis", "-e", "ISO-2022-JP", p.name]),
         out=buf, engine="auto")
assert rc == 0 and b"no-jax finding" in buf.getvalue()
args = parse_args(["-t", "x", "-e", "UTF-8", "-"])
ms = Missions.from_args(args)
buf2 = io.BytesIO()
_run_streaming_stdin(args, ms, buf2, src=io.BytesIO(bytes(blob)),
                     chunk_bytes=1 << 20, engine="auto")
assert b"no-jax finding" in buf2.getvalue()
assert "jax" not in sys.modules
os.unlink(p.name)
print("NO_JAX_OK")
"""


def test_default_scan_paths_never_import_jax():
    env = dict(os.environ)
    p = subprocess.run(
        [sys.executable, "-c", _SCRIPT % {"repo": REPO}],
        capture_output=True, text=True, timeout=300, env=env,
    )
    assert p.returncode == 0, p.stderr[-3000:]
    assert "NO_JAX_OK" in p.stdout
