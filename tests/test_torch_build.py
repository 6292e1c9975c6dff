"""The kernel build under several processes: processes that reach the
build at once, with no library built, compile once and load one file.

``nvcc`` is absent here, so ``_build._compile`` is replaced by a stub that
sleeps (a build takes seconds), counts itself in a file and writes the
library where the real one would."""
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

RACER = textwrap.dedent("""
    import os, pathlib, sys, time
    from repro_torch.kernels import _build

    root, count, go = map(pathlib.Path, sys.argv[1:4])
    _build.BUILD_ROOT = root

    def stub(out_dir):
        with open(count, "a") as f:
            f.write("compile\\n")
        time.sleep(float(sys.argv[4]))
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / _build.LIB_NAME).write_bytes(b"stub library")
        return out_dir / _build.LIB_NAME

    _build._compile = stub
    (go.parent / f"ready.{os.getpid()}").touch()
    while not go.exists():          # start the racers together
        time.sleep(0.005)
    print(_build.build_library(), _build.build_seconds is not None, flush=True)
""")


def _race(tmp_path, n, sleep):
    root, count, go = tmp_path / "build", tmp_path / "compiles", tmp_path / "go"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", RACER, str(root), str(count), str(go),
                               str(sleep)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(n)]
    try:
        # every racer is past its imports and polling before the go
        t0 = time.monotonic()
        while len(list(tmp_path.glob("ready.*"))) < n and time.monotonic() - t0 < 60:
            time.sleep(0.01)
        go.touch()
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    return [out.split() for out, _ in outs], count.read_text().splitlines(), root


@pytest.mark.timeout(180)
def test_racing_processes_compile_once_and_load_one_library(tmp_path):
    rows, compiles, root = _race(tmp_path, n=3, sleep=1.5)
    assert compiles == ["compile"]
    paths = {path for path, _ in rows}
    assert len(paths) == 1
    path = pathlib.Path(paths.pop())
    assert path == root / _build._digest() / _build.LIB_NAME
    assert path.read_bytes() == b"stub library"
    # the one that compiled timed its build; the others found it built
    assert sorted(built for _, built in rows) == ["False", "False", "True"]
    # the lock file stays beside the build directory, holding no lock
    assert (root / f"{_build._digest()}.lock").exists()


def test_a_built_library_is_found_without_the_lock(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    lib = tmp_path / _build._digest() / _build.LIB_NAME
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"built")

    def no_compile(out_dir):
        raise AssertionError("compiled a built library")

    monkeypatch.setattr(_build, "_compile", no_compile)
    assert _build.build_library() == lib
    assert not list(tmp_path.glob("*.lock"))
