"""The port stands alone: no module of it, and neither chip_smoke.py nor
scripts/torch_profile_decode.py, imports jax, jaxlib or the JAX package
(statically, and at run time with jax blocked); and the modules it copied
from the JAX package have not drifted from their originals (the NF4 code
book among them, the placement registry, which differs from its original
only in its module docstring, and the byte-equal copies of the chaos
layer, the task pool and the wire codec's source)."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest

from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    config as jconfig,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.models import (
    quant as jquant,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.runtime import (
    errors as jerrors,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.scheduling import (
    registry as jregistry,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu.utils import (
    flags as jflags,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    config as tconfig,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.models import (
    quant as tquant,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.runtime import (
    errors as terrors,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.scheduling import (
    registry as tregistry,
)
from global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu_torch.utils import (
    flags as tflags,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = "global_capstone_design_distributed_inference_of_llms_over_the_internet_tpu"
PORT_PKG = JAX_PKG + "_torch"
FORBIDDEN = {"jax", "jaxlib", JAX_PKG}


def _port_files():
    return sorted((REPO / PORT_PKG).rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "torch_profile_decode.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_module_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) >= 20 and all(p.exists() for p in files)
    bad = {str(p.relative_to(REPO)): sorted(_imported_roots(p) & FORBIDDEN)
           for p in files if _imported_roots(p) & FORBIDDEN}
    assert not bad, bad


def test_every_port_module_imports_with_jax_blocked():
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .removesuffix(".__init__") for p in (REPO / PORT_PKG).rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for name in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"assert not any(k.split('.')[0] in {sorted(FORBIDDEN)!r} "
        "for k, v in sys.modules.items() if v is not None)\n"
        "print('imported', len(" f"{mods!r}" "))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(mods)}" in proc.stdout


@pytest.mark.parametrize("module", ["draw_kernel", "int8_kernel", "nf4_kernel"])
def test_importing_a_kernel_wrapper_builds_nothing(module):
    """A kernel wrapper, the sampler and the graphs import without building
    or loading any library: the build waits for the first launch (or
    ``build()``), so the CPU tests, which import every module, build
    nothing."""
    code = (
        "import importlib\n"
        f"m = importlib.import_module('{PORT_PKG}.ops.{module}')\n"
        f"importlib.import_module('{PORT_PKG}.runtime.graphs')\n"
        f"from {PORT_PKG}.utils import cuda_build\n"
        "print(m._lib is None, m._launches, sorted(cuda_build._loaded), "
        "sorted(cuda_build.build_logs))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[0] == "True 0 [] []"


def _field_table(cls):
    return [(f.name, f.default, f.default_factory is not dataclasses.MISSING)
            for f in dataclasses.fields(cls)]


def test_model_config_copy_has_not_drifted():
    assert _field_table(tconfig.ModelConfig) == _field_table(jconfig.ModelConfig)
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    for name in jconfig.PRESETS:
        assert dataclasses.asdict(tconfig.PRESETS[name]()) == \
            dataclasses.asdict(jconfig.PRESETS[name]()), name
    assert dataclasses.asdict(tconfig.get_config("meta-llama-3.1-8b")) == \
        dataclasses.asdict(jconfig.get_config("meta-llama-3.1-8b"))


@pytest.mark.parametrize("table", ["flags", "errors", "registry", "nf4"])
def test_copied_catalogs_have_not_drifted(table):
    if table == "nf4":
        assert tquant.NF4_LEVELS == jquant.NF4_LEVELS
        assert tquant.NF4_BLOCK == jquant.NF4_BLOCK
    elif table == "flags":
        assert {k: dataclasses.asdict(v) for k, v in tflags.FLAGS.items()} == \
            {k: dataclasses.asdict(v) for k, v in jflags.FLAGS.items()}
    elif table == "errors":
        assert {k: dataclasses.asdict(v) for k, v in terrors.TAXONOMY.items()} == \
            {k: dataclasses.asdict(v) for k, v in jerrors.TAXONOMY.items()}
    else:
        assert tregistry.REC_FIELDS == jregistry.REC_FIELDS
        assert _field_table(tregistry.ServerRecord) == _field_table(jregistry.ServerRecord)
        assert (tregistry.DEFAULT_TTL, tregistry.DISCOVERY_POOL) == \
            (jregistry.DEFAULT_TTL, jregistry.DISCOVERY_POOL)


def _without_module_docstring(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    first = tree.body[0]
    assert isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant)
    lines = path.read_text(encoding="utf-8").splitlines(keepends=True)
    return "".join(lines[first.end_lineno:])


@pytest.mark.parametrize("rel", ["runtime/faults.py", "runtime/task_pool.py",
                                 "csrc/codec.cpp"])
def test_byte_equal_copies(rel):
    """The chaos layer, the task pool and the wire codec's C++ source are
    copies of the JAX package's, byte for byte (the codec's lives in its
    ``native/``)."""
    original = rel.replace("csrc/", "native/")
    assert (REPO / PORT_PKG / rel).read_bytes() == (REPO / JAX_PKG / original).read_bytes()


def test_registry_copy_differs_from_its_original_only_in_the_docstring():
    rel = pathlib.Path("scheduling") / "registry.py"
    assert _without_module_docstring(REPO / PORT_PKG / rel) == \
        _without_module_docstring(REPO / JAX_PKG / rel)
