"""Build distributable packages: wheel + Debian package.

The analog of the reference's release pipeline
(/root/reference/scripts/12-make-targets + 15-build-packages: 7
cross-compiled Rust targets + .deb). A Python/C++ framework's natural
targets are per-platform WHEELS; this script builds:

  dist/stringsext_tpu-<ver>-py3-none-any.whl
      (ships the optimized host .so AND the portable
       libemitter-generic.so; a toolchain-less install rebuilds or
       falls back with a one-time warning - tests/test_packaging.py)
  dist/stringsext-tpu_<ver>_amd64.deb
      (wheel contents under /usr/lib/python3/dist-packages, a
       /usr/bin/stringsext wrapper, the man page)

Cross targets: this image carries no cross toolchains (no
aarch64-linux-gnu-g++ / mingw), so non-amd64 debs are out of scope
here; the wheel path covers them (the generic .so is -mtune only and
any-platform pip installs rebuild natively).

Usage: python scripts/build_packages.py [outdir]
"""

import gzip
import os
import shutil
import subprocess
import sys
import zipfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    outdir = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                             else os.path.join(REPO, "dist"))
    os.makedirs(outdir, exist_ok=True)

    from stringsext_tpu import __version__ as ver

    # 1. wheel
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", ".", "--no-deps",
         "--no-build-isolation", "-w", outdir],
        cwd=REPO, check=True,
    )
    wheels = [f for f in os.listdir(outdir)
              if f.startswith("stringsext_tpu-") and f.endswith(".whl")]
    assert wheels, "wheel build produced nothing"
    wheel = os.path.join(outdir, sorted(wheels)[-1])
    print(f"wheel: {wheel}")

    # 2. deb (amd64; dpkg-deb is part of the base image)
    if shutil.which("dpkg-deb") is None:
        print("dpkg-deb not available; skipping deb")
        return
    root = os.path.join(outdir, "_debroot")
    shutil.rmtree(root, ignore_errors=True)
    site = os.path.join(root, "usr", "lib", "python3", "dist-packages")
    os.makedirs(site)
    with zipfile.ZipFile(wheel) as z:
        z.extractall(site)
    bindir = os.path.join(root, "usr", "bin")
    os.makedirs(bindir)
    launcher = os.path.join(bindir, "stringsext")
    with open(launcher, "w") as f:
        f.write("#!/usr/bin/python3\n"
                "import sys\n"
                "from stringsext_tpu.cli import main\n"
                "sys.exit(main())\n")
    os.chmod(launcher, 0o755)
    mandir = os.path.join(root, "usr", "share", "man", "man1")
    os.makedirs(mandir)
    with open(os.path.join(REPO, "docs", "stringsext-tpu.1"), "rb") as f:
        man = f.read()
    with gzip.open(os.path.join(mandir, "stringsext.1.gz"), "wb",
                   compresslevel=9) as f:
        f.write(man)
    ctrl = os.path.join(root, "DEBIAN")
    os.makedirs(ctrl)
    with open(os.path.join(ctrl, "control"), "w") as f:
        f.write(
            f"Package: stringsext-tpu\n"
            f"Version: {ver}\n"
            f"Architecture: amd64\n"
            f"Maintainer: stringsext-tpu authors\n"
            f"Depends: python3 (>= 3.10), python3-numpy\n"
            f"Section: utils\n"
            f"Priority: optional\n"
            f"Description: data-parallel Unicode string extractor\n"
            f" Finds multi-byte encoded strings in binary data\n"
            f" (stringsext-compatible CLI; JAX/Pallas device kernels\n"
            f" optional at runtime).\n"
        )
    deb = os.path.join(outdir, f"stringsext-tpu_{ver}_amd64.deb")
    subprocess.run(["dpkg-deb", "--root-owner-group", "-b", root, deb],
                   check=True)
    shutil.rmtree(root)
    print(f"deb: {deb}")


if __name__ == "__main__":
    main()
