"""The port's copies of the tutorial notebooks
(``generativeaiexamples_tpu_torch/notebooks/``) against JAX's
(``notebooks/``), on the CPU.

Each notebook runs cell by cell in a fresh interpreter and a temporary
directory, as tests/test_notebooks.py runs JAX's: the port's copy with its
device line set to ``"cpu"``, JAX's with ``PORT = 8095``/``8096`` set to a
free port in memory (the ``.ipynb`` files are never edited). Both run with
the ``APP_*`` environment cleared, except that each run's vector store and
uploads go to its own temporary directory (``APP_VECTORSTORE_PERSISTDIR``,
``DOC_UPLOAD_DIR``): both packages default to one shared directory, where
other runs' documents would change the counts and passages printed. What
each cell prints must be equal, but in two notebooks:

- 03 prints token ids of random weights, and each package draws its own
  (of another preset too: the port's copy serves ``kernel-8dev``, whose
  head dimension the card's kernels take, where JAX's serves ``debug``;
  both have 512 ids), so the test holds their shape: 16 ids at most, each
  in the vocabulary, and one count of at most 16 for each of the 4
  requests;
- 09 ingests its own package's ``parallel/`` sources, which differ, so the
  test holds the file count (8 in both), the stats' keys and that each of
  the 3 hits names a file of the port's ``parallel/`` and quotes its text.

The port's run must load neither jax nor the JAX package."""
import ast
import json
import os
import pathlib
import re
import socket
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_NOTEBOOKS = REPO / "notebooks"
PORT_NOTEBOOKS = REPO / "generativeaiexamples_tpu_torch" / "notebooks"
NAMES = sorted(p.stem for p in JAX_NOTEBOOKS.glob("*.ipynb"))
DEVICE_LINE = re.compile(r"^DEVICE = None\b.*$", re.M)
FORBIDDEN = ("jax", "generativeaiexamples_tpu", "experimental", "tools", "integrations", "aiohttp")

# runs the cells in one scope, each output after a marker, then the modules loaded
DRIVER = r'''
import json, sys
cells = json.load(open(sys.argv[1]))
scope = {"__name__": "__main__"}
for i, src in enumerate(cells):
    print(f"\n<<cell {i}>>", flush=True)
    exec(compile(src, f"<cell {i}>", "exec"), scope)
    sys.stdout.flush()
print("\n<<modules>>" + json.dumps(sorted(sys.modules)), flush=True)
'''


def _code_cells(path: pathlib.Path) -> list:
    nb = json.loads(path.read_text())
    return ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(cells, tmp: pathlib.Path) -> tuple:
    """(each cell's stdout, the modules loaded) of one run in ``tmp``."""
    tmp.mkdir()
    (tmp / "cells.json").write_text(json.dumps(cells))
    (tmp / "driver.py").write_text(DRIVER)
    env = {k: v for k, v in os.environ.items() if not k.startswith("APP_")}
    # one compute thread: the test runs beside the rest of the suite's workers
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               APP_VECTORSTORE_PERSISTDIR=str(tmp / "vectorstore"),
               DOC_UPLOAD_DIR=str(tmp / "uploads"))
    proc = subprocess.run([sys.executable, "driver.py", "cells.json"], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (
        f"stdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-3000:]}")
    body, modules = proc.stdout.split("\n<<modules>>")
    outs = re.split(r"\n<<cell \d+>>\n", body)[1:]
    assert len(outs) == len(cells)
    return outs, json.loads(modules)


def _port_cells(name: str) -> list:
    cells = _code_cells(PORT_NOTEBOOKS / f"{name}.ipynb")
    cells[0], n = DEVICE_LINE.subn('DEVICE = "cpu"', cells[0])
    assert n == 1
    return cells


def _jax_cells(name: str) -> list:
    port = _free_port()
    return [re.sub(r"^PORT = 809[56]$", f"PORT = {port}", c, flags=re.M)
            for c in _code_cells(JAX_NOTEBOOKS / f"{name}.ipynb")]


def _same_shape_03(port_outs, jax_outs) -> None:
    for outs in (port_outs, jax_outs):
        ids = json.loads(outs[2].strip().removeprefix("generated token ids: "))
        assert len(ids) <= 16 and all(0 <= i < 512 for i in ids)
        counts = {int(k): v for k, v in re.findall(r"(\d+): (\d+)", outs[3])}
        assert set(counts) == {0, 1, 2, 3} and all(0 <= int(v) <= 16 for v in counts.values())


def _same_shape_09(port_outs, jax_outs) -> None:
    stats = [ast.literal_eval(outs[1].strip()) for outs in (port_outs, jax_outs)]
    assert stats[0].keys() == stats[1].keys()
    assert stats[0]["docs_in"] == stats[1]["docs_in"] == 8 and stats[0]["chunks_out"] > 0
    parallel = REPO / "generativeaiexamples_tpu_torch" / "parallel"
    hits = re.findall(r"^--- (\S+)\n(.*)$", port_outs[2], re.M)
    assert len(hits) == 3
    for name, text in hits:
        source = " ".join((parallel / name).read_text().split())
        assert text.strip() and text.strip() in source


@pytest.mark.parametrize("name", NAMES)
def test_port_notebook_prints_what_jax_s_prints(name, tmp_path):
    port_outs, port_modules = _run(_port_cells(name), tmp_path / "port")
    jax_outs, _ = _run(_jax_cells(name), tmp_path / "jax")
    loaded = [m for m in port_modules
              if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert loaded == []
    if name.startswith("03_"):
        _same_shape_03(port_outs, jax_outs)
    elif name.startswith("09_"):
        _same_shape_09(port_outs, jax_outs)
    else:
        assert port_outs == jax_outs
        assert any(out.strip() for out in port_outs)


def test_every_jax_notebook_has_its_copy():
    assert len(NAMES) == 10
    assert sorted(p.stem for p in PORT_NOTEBOOKS.glob("*.ipynb")) == NAMES
    for name in NAMES:
        port = _code_cells(PORT_NOTEBOOKS / f"{name}.ipynb")
        assert len(port) == len(_code_cells(JAX_NOTEBOOKS / f"{name}.ipynb"))
        assert len(DEVICE_LINE.findall(port[0])) == 1
        # every later cell runs where the first says: no cell names a device of its own
        assert not any(re.search(r"device=\"|cuda", c) for c in port)
