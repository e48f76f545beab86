"""The PyTorch port stands alone: no module of generativeaiexamples_tpu_torch
and neither chip_smoke.py nor kernel_sweep.py imports jax or the JAX package
(generativeaiexamples_tpu), nor the root ``integrations`` package (its
adapters import the JAX package), nor aiohttp, pydantic, bleach, requests,
safetensors, transformers, optax or orbax, which the GPU machine lacks; checked two ways: by importing every port
module in a fresh interpreter and reading sys.modules, and by scanning the
port's sources for import statements. Names match exactly or up to a dot
(``generativeaiexamples_tpu_torch`` is not the JAX package)."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "generativeaiexamples_tpu_torch"
FORBIDDEN = ("jax", "generativeaiexamples_tpu", "integrations", "aiohttp", "pydantic", "bleach",
             "requests", "safetensors", "transformers", "optax", "orbax")


def _forbidden(module: str) -> bool:
    return any(module == name or module.startswith(name + ".") for name in FORBIDDEN)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_sweep.py"]


def test_name_matching_is_exact_or_dotted():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("generativeaiexamples_tpu") and _forbidden("generativeaiexamples_tpu.ops")
    assert not _forbidden("generativeaiexamples_tpu_torch")
    assert not _forbidden("generativeaiexamples_tpu_torch.ops.quant")
    assert not _forbidden("jaxlib_like") and not _forbidden("torch")
    assert _forbidden("aiohttp.web") and _forbidden("pydantic") and _forbidden("bleach")
    assert _forbidden("requests") and not _forbidden("requests_toolbelt_like")


@pytest.mark.parametrize("module,forbidden", [
    ("integrations", True),
    ("integrations.langchain_tpu", True),
    ("integrations.llamaindex_tpu", True),
    ("integrations.pandasai_tpu", True),
    ("generativeaiexamples_tpu_torch.integrations", False),
    ("generativeaiexamples_tpu_torch.integrations.langchain", False),
    ("generativeaiexamples_tpu_torch.integrations.llamaindex", False),
    ("generativeaiexamples_tpu_torch.integrations.pandasai", False),
    ("integrations_like", False),
])
def test_the_root_integrations_package_is_forbidden_and_the_port_s_is_not(module, forbidden):
    assert _forbidden(module) is forbidden


def test_importing_every_port_module_loads_neither_jax_nor_the_jax_package():
    mods = _port_modules() + ["chip_smoke", "kernel_sweep"]
    assert "generativeaiexamples_tpu_torch.engine.llm_engine" in mods
    assert "generativeaiexamples_tpu_torch.ops.decode_attention" in mods
    assert "generativeaiexamples_tpu_torch.server.api" in mods
    assert "generativeaiexamples_tpu_torch.chains.developer_rag" in mods
    assert "generativeaiexamples_tpu_torch.integrations.llamaindex" in mods
    assert "generativeaiexamples_tpu_torch.retrieval.native_store" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if _forbidden(m)] == []
    assert "torch" in loaded


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            imported.append(node.module)
    assert [m for m in imported if _forbidden(m)] == []


# the notebooks' cells: nor the JAX repository's root ``experimental`` and
# ``tools`` packages (each has its counterpart under the port)
NOTEBOOK_FORBIDDEN = FORBIDDEN + ("experimental", "tools")


@pytest.mark.parametrize("path", sorted((PORT / "notebooks").glob("*.ipynb")),
                         ids=lambda p: p.name)
def test_notebook_cells_import_neither_jax_nor_the_jax_package(path):
    cells = [cell for cell in json.loads(path.read_text(encoding="utf-8"))["cells"]
             if cell["cell_type"] == "code"]
    assert cells
    imported = []
    for cell in cells:
        for node in ast.walk(ast.parse("".join(cell["source"]))):
            if isinstance(node, ast.Import):
                imported += [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                imported.append(node.module)
    assert any(m.startswith("generativeaiexamples_tpu_torch") for m in imported)
    assert [m for m in imported
            if any(m == name or m.startswith(name + ".") for name in NOTEBOOK_FORBIDDEN)] == []
