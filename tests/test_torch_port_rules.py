"""Rules of the port: ``repro_torch`` imports neither JAX nor the JAX
package — by statement or by a module name in a string, as a registry
hands to ``importlib.import_module`` — and its entry points run on the
card unless the caller asks for the CPU: asking for CUDA without a card
raises instead of falling back.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)"
    r"|from\s+repro(\.|\s))", re.M)
# import_module("repro...") / __import__("jax"), and any string literal
# naming a module of either (a registry entry resolved later by string).
FORBIDDEN_STRING = re.compile(
    r"""(import_module|__import__)\s*\(\s*[rRbBuUfF]*["'](jax|repro)\b(?!_)"""
    r"""|["'](jax|repro)\.[A-Za-z_]""")


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.serving, repro_torch.convert\n"
        "import repro_torch.models.dcn_models, repro_torch.core.simulator\n"
        "import repro_torch.kernels.dcn_fused, repro_torch.obs.export\n"
        "import repro_torch.kernels._build, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.dcn_bli, repro_torch.testing\n"
        "import repro_torch.runtime.pipeline, repro_torch.runtime\n"
        "import repro_torch.tuning, repro_torch.core\n"
        "from repro_torch.core import simulate_group, make_square_grid\n"
        "import repro_torch.models.lm, repro_torch.configs\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.flash_decode\n"
        "import repro_torch.launch.serve, repro_torch.launch.mesh\n"
        "import repro_torch.runtime.shard\n"
        "import repro_torch.optim, repro_torch.checkpoint, repro_torch.data\n"
        "import repro_torch.launch.steps, repro_torch.launch.train\n"
        "import repro_torch.launch.elastic, repro_torch._tree\n"
        "from repro_torch.core import fused_deformable_conv2d\n"
        "from repro_torch.configs import get_dcn_config\n"
        "from repro_torch.models.dcn_models import layer_shapes\n"
        "from repro_torch import configs\n"
        "for arch in configs.SUPPORTED_ARCHS:\n"
        "    configs.get_config(arch, smoke=True)\n"
        "assert configs.get_config('qwen3-1.7b', smoke=True).qk_norm\n"
        "print('ok')\n")
    src = str(PKG.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(p.relative_to(PKG).as_posix()
                                        for p in PKG.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    text = (PKG / path).read_text()
    assert not FORBIDDEN.search(text), path
    assert not FORBIDDEN_STRING.search(text), path


def test_get_config_refuses_only_the_unported_arch():
    """No arch id is left unported: every JAX arch id resolves, ``full()``
    and ``smoke()`` alike, to the JAX package's config field for field,
    llama-3.2-vision's cross-attention layers included."""
    import dataclasses

    from repro import configs as j_configs
    from repro_torch import configs

    assert configs.ARCHS == j_configs.ARCHS == configs.SUPPORTED_ARCHS
    for arch in configs.ARCHS:
        for smoke in (False, True):
            assert dataclasses.asdict(configs.get_config(arch, smoke=smoke)) \
                == dataclasses.asdict(j_configs.get_config(arch, smoke=smoke))
    llama = configs.get_config("llama-3.2-vision-11b")
    assert [s.cross for s in llama.pattern] == [False] * 3 + [True, False]
    assert (llama.d_cross, llama.n_cross_tokens) == (4096, 1601)
    for arch in ("jamba-v0.1-52b", "xlstm-1.3b"):
        assert configs.get_config(arch).sub_quadratic
        assert configs.get_config(arch, smoke=True).n_layers == 8


@pytest.mark.parametrize("line", [
    'importlib.import_module("repro.configs.qwen3_1_7b")',
    "__import__('jax')",
    '_MODULES = {"qwen3-1.7b": "repro.configs.qwen3_1_7b"}',
])
def test_string_import_rule_catches_string_imports(line):
    assert FORBIDDEN_STRING.search(line)
    assert not FORBIDDEN_STRING.search(
        line.replace("repro", "repro_torch").replace("jax", "numpy"))


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    from repro_torch import configs
    from repro_torch.convert import lm_params_from_jax, params_from_jax
    from repro_torch.models import lm
    from repro_torch.models.dcn_models import DcnNetConfig, init_dcn_net
    from repro_torch.serving import DcnServingEngine, DecodeEngine

    cfg = DcnNetConfig("vgg19", n_deform=1, img_size=8, width_mult=0.125)
    with pytest.raises(RuntimeError, match="cuda"):
        init_dcn_net(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"fc": {"w": np.zeros((2, 2), np.float32)}})
    params = init_dcn_net(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        DcnServingEngine(params, cfg)
    from repro_torch.runtime.graph import build_graph
    from repro_torch.tuning import representative_input
    with pytest.raises(RuntimeError, match="cuda"):
        representative_input(build_graph(cfg))
    from repro_torch.launch.mesh import DeviceMesh
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceMesh.on("cuda", data=2)
    lm_cfg = configs.get_config("qwen3-1.7b", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_lm(lm_cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        lm_params_from_jax({"embed": np.zeros((1, 2, 2), np.float32)})
    lm_params = lm.init_lm(lm_cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        DecodeEngine(lm_params, lm_cfg, batch=1, max_len=8)
    from repro_torch import checkpoint
    from repro_torch.launch.train import dcn_train_loop, train_loop
    with pytest.raises(RuntimeError, match="cuda"):
        train_loop(lm_cfg, configs.ShapeCell("t", "train", 8, 1), steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        dcn_train_loop(cfg, steps=1)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, {"w": params["fc"]["w"]})
        with pytest.raises(RuntimeError, match="cuda"):
            checkpoint.restore(d, 1, {"w": params["fc"]["w"]})


def _c_kind(arg: str) -> str:
    """Pointer, float or int, from one C parameter declaration."""
    if "*" in arg:
        return "p"
    if re.search(r"\b(float|double)\b", arg):
        return "f"
    assert re.search(r"\b(int|long|size_t|int\d+_t)\b", arg), arg
    return "i"


_CTYPE_KIND = {"c_void_p": "p", "c_float": "f", "c_int": "i"}


def test_ctypes_signatures_match_the_c_entry_points():
    """Every C entry point's ctypes argtypes have its arity and kinds
    (pointer, float or int): a missing int would pass the stream
    truncated, and a float declared c_int would be cut to an integer."""
    from repro_torch.kernels._build import _SIGNATURES

    decl = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)
    found = {}
    for src in (PKG / "csrc").glob("*.cu"):
        for name, args in decl.findall(src.read_text()):
            found[name] = [_c_kind(a) for a in args.split(",") if a.strip()]
    assert set(found) == set(_SIGNATURES)
    assert "f" in found["flash_attention_launch"]
    for name, argtypes in _SIGNATURES.items():
        kinds = [_CTYPE_KIND[t.__name__] for t in argtypes]
        assert kinds == found[name], name
