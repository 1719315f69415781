"""Rules of the port: ``repro_torch`` imports neither JAX nor the JAX
package, and its entry points run on the card unless the caller asks for
the CPU — asking for CUDA without a card raises instead of falling back.
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
        "import repro_torch.runtime.pipeline\n"
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
    assert not FORBIDDEN.search((PKG / path).read_text()), path


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    from repro_torch.convert import params_from_jax
    from repro_torch.models.dcn_models import DcnNetConfig, init_dcn_net
    from repro_torch.serving import DcnServingEngine

    cfg = DcnNetConfig("vgg19", n_deform=1, img_size=8, width_mult=0.125)
    with pytest.raises(RuntimeError, match="cuda"):
        init_dcn_net(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"fc": {"w": np.zeros((2, 2), np.float32)}})
    params = init_dcn_net(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        DcnServingEngine(params, cfg)


def test_ctypes_signatures_match_the_c_entry_points():
    """Every C entry point's ctypes argtypes have its arity and kinds
    (pointer vs int): a missing int would pass the stream truncated."""
    from repro_torch.kernels._build import _SIGNATURES

    decl = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)
    found = {}
    for src in (PKG / "csrc").glob("*.cu"):
        for name, args in decl.findall(src.read_text()):
            found[name] = ["p" if "*" in a else "i"
                           for a in args.split(",") if a.strip()]
    assert set(found) == set(_SIGNATURES)
    for name, argtypes in _SIGNATURES.items():
        kinds = ["p" if t.__name__ == "c_void_p" else "i" for t in argtypes]
        assert kinds == found[name], name
