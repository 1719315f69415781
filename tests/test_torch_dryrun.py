"""The port's dry run (``launch.dryrun``) and its op-level analysis
(``launch.op_analysis``), on the CPU at smoke sizes.

* the analysis itself, as the JAX ``TestHloAnalysis`` holds
  ``hlo_analysis``: a loop of 7 products counted 7 times, no copy on one
  device, a copy between two devices charged to the receiver;
* per-chip FLOPs on a (1, 1) mesh equal to JAX's ``analyze_hlo`` of the
  same cell (B 4, S 64, float32), compiled as ``tests/test_launch.py``
  compiles it, for qwen3 / granite / deepseek x train / prefill / decode;
  xlstm's train cell differs by the products ROADMAP.md §3 names;
* qwen3 smoke over a (2, 2) mesh of ``meta`` devices: #7 / #8 launches a
  device (one a layer, row and rank), each device's argument bytes equal
  to the slices ``ShardedTree.place`` puts on ``DeviceMesh.on("cpu", 2,
  2)``'s rank, and no op on a device outside the mesh;
* the kernel sites: a fake tensor's call is reported to the analysis
  (the wrapper's ``launches`` stays, as nothing is launched), a CPU
  tensor still runs the plain version, a plain ``meta`` tensor is
  refused; the FLOPs a launch is charged equal the plain version's;
* ``make_production_mesh`` and ``run_cell`` / ``main``'s records.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro.configs.base import ShapeCell as JShapeCell
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.launch.steps import build_step as j_build_step
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch import configs
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import dryrun, make_production_mesh, mesh_chips
from repro_torch.launch.mesh import DeviceMesh, meta_mesh
from repro_torch.launch.op_analysis import analyze_step
from repro_torch.launch.steps import build_step
from repro_torch.models import lm
from repro_torch.models.params import ShardedTree, leaves


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fakes(*shapes, device="meta:0"):
    with FakeTensorMode():
        return [torch.empty(s, device=device) for s in shapes]


# -- the analysis (the JAX TestHloAnalysis) --------------------------------

def test_a_loop_of_products_counts_every_trip():
    x, w = _fakes((8, 64), (64, 64))

    def f(c, w):
        for _ in range(7):
            c = torch.tanh(c @ w)
        return c

    a = analyze_step(f, x, w)
    assert a["flops"] == 7 * 2 * 8 * 64 * 64
    assert a["devices"] == ["meta:0"]
    assert a["traffic_by_kind"]["mm"] == 7 * 4 * (8 * 64 + 64 * 64 + 8 * 64)


def test_one_device_copies_nothing():
    (x,) = _fakes((8,))
    a = analyze_step(lambda x: x * 2, x)
    assert a["collective_bytes"] == 0 and a["collectives"] == {}


def test_a_copy_is_charged_to_the_receiving_device():
    (x,) = _fakes((8, 64))
    a = analyze_step(lambda x: x.to("meta:1"), x)
    assert a["devices"] == ["meta:0", "meta:1"]
    assert [r["collective_bytes"] for r in a["per_device"]] == [0, 2048]
    assert a["collective_bytes"] == 2048
    (who,) = a["collectives"]
    assert a["collectives"][who] == {"count": 1, "bytes": 2048}


def test_memory_counts_arguments_results_and_the_peak_of_temporaries():
    x, w = _fakes((8, 64), (64, 64))

    def f(x, w):
        t = torch.tanh(x @ w)
        return (t @ w).sum()            # t, t @ w and the sum alive at once

    a = analyze_step(f, x, w)
    assert a["memory"]["argument_bytes"] == 4 * (8 * 64 + 64 * 64)
    assert a["memory"]["output_bytes"] == 4
    assert a["memory"]["temp_bytes"] == 2 * 4 * 8 * 64
    assert a["memory"]["peak_bytes"] == 2 * 4 * 8 * 64 + 4


def test_real_tensors_are_refused():
    with pytest.raises(ValueError, match="fake tensors"):
        analyze_step(lambda x: x, torch.zeros(2))


# -- per-chip FLOPs on (1, 1) against JAX's analyze_hlo ----------------------

def _jax_flops(arch: str, kind: str) -> float:
    cfg = j_configs.get_config(arch, smoke=True)
    mesh = j_make_host_mesh(1, 1)
    b = j_build_step(cfg, JShapeCell("t", kind, 64, 4), mesh,
                     opt_cfg=JAdamWConfig(), param_dtype=jnp.float32)
    with mesh:
        compiled = b.fn.lower(*b.args_abstract).compile()
    return analyze_hlo(compiled.as_text())["flops"]


def _dry(arch: str, kind: str, mesh: str = "1x1", batch: int = 4,
         **kw) -> dict:
    cfg = configs.get_config(arch, smoke=True)
    if kind == "prefill":
        cfg = dataclasses.replace(cfg, use_flash=True)
    m = meta_mesh(*(int(n) for n in mesh.split("x")))
    b = build_step(cfg, ShapeCell("t", kind, 64, batch), m,
                   param_dtype=torch.float32, **kw)
    return analyze_step(b.fn, *b.args_abstract, mesh=m)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m",
                                  "deepseek-v3-671b"])
def test_flops_at_1x1_equal_jax(arch, kind):
    a = _dry(arch, kind)
    assert a["flops"] == _jax_flops(arch, kind)
    assert a["off_mesh_ops"] == 0
    if kind != "train" and arch != "deepseek-v3-671b":    # MLA runs no kernel
        name = "flash_attention" if kind == "prefill" else "flash_decode"
        assert a["kernels"][name]["launches"] == [
            configs.get_config(arch, smoke=True).n_layers]


def test_xlstm_train_flops_differ_from_jax_by_the_named_products():
    """ROADMAP.md §3: per mLSTM layer of this cell (8 chunks) the port
    runs 14 more products of 8,192 FLOPs and 5 more of 524,288 than XLA's
    program (checkpoint recompute, K = 1 products as ``bmm``); its one
    sLSTM layer one fewer of 65,536 (no gradient for the zero initial
    hidden state)."""
    cfg = configs.get_config("xlstm-1.3b", smoke=True)
    mlstm = sum(s.kind == "mlstm" for s in cfg.pattern) * cfg.n_repeats
    assert mlstm == 7
    extra = mlstm * (14 * 8192 + 5 * 524288) - 65536
    assert _dry("xlstm-1.3b", "train")["flops"] == \
        _jax_flops("xlstm-1.3b", "train") + extra


# -- qwen3 smoke over a (2, 2) mesh of meta devices --------------------------

QWEN = configs.get_config("qwen3-1.7b", smoke=True)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_qwen3_over_2x2_launches_arguments_and_devices(kind):
    a = _dry("qwen3-1.7b", kind, mesh="2x2")
    assert a["off_mesh_ops"] == 0
    assert a["devices"] == [f"meta:{k}" for k in range(4)]
    if kind != "train":
        name = "flash_attention" if kind == "prefill" else "flash_decode"
        assert a["kernels"] == {name: {
            "launches": [QWEN.n_layers] * 4,
            "flops": a["kernels"][name]["flops"]}}
    else:
        assert a["kernels"] == {}
    # The same slices placed on one CPU four times: bytes per rank.
    cpu = DeviceMesh.on("cpu", 2, 2)
    shape = ShapeCell("t", kind, 64, 4)
    b = build_step(QWEN, shape, cpu, param_dtype=torch.float32)
    params = lm.init_lm(QWEN, 0, device="cpu")
    placed = ShardedTree.place(params, b.param_shardings, cpu)
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in leaves(tree) if t is not None)
    want = [nbytes(placed.shards[i][r]) for i in range(2) for r in range(2)]
    if kind == "train":                 # the moments and the step count
        want = [3 * n for n in want]
        want[0] += 4
    if kind == "decode":
        cache = lm.init_cache(QWEN, 4, 64, device="cpu")   # bf16
        from repro_torch.models.transformer import cache_split, shard_cache
        sc = shard_cache(QWEN, cache, cpu, cache_split(placed["layers"],
                                                       QWEN))
        want = [n + nbytes(sc.shards[i][r]) for n, (i, r) in zip(
            want, [(0, 0), (0, 1), (1, 0), (1, 1)])]
        want[0] += 2 * 4 * 4            # token and pos, (4, 1) and (4,)
    else:
        want[0] += 4 * 4 * (64 + (kind == "train"))        # the tokens
    assert [r["memory"]["argument_bytes"] for r in a["per_device"]] == want


# -- the kernel sites ---------------------------------------------------------

def test_wrappers_count_fake_tensors_and_run_the_plain_version_on_the_cpu():
    q, k, v = _fakes((2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8))
    before = fa.flash_attention.launches
    a = analyze_step(lambda q, k, v: fa.flash_attention(q, k, v), q, k, v)
    assert fa.flash_attention.launches == before        # nothing launched
    assert a["kernels"]["flash_attention"]["launches"] == [1]
    assert a["kernels"]["flash_attention"]["flops"] == [
        fa.plain_flops(2, 16, 16, 4, 8)]
    nb = 4 * (2 * 16 * 4 * 8 * 2 + 2 * 2 * 16 * 2 * 8)
    assert a["traffic_by_kind"]["flash_attention"] == nb
    # A CPU tensor runs the plain version, a plain meta tensor is refused.
    g = torch.Generator().manual_seed(0)
    real = [torch.randn(t.shape, generator=g) for t in (q, k, v)]
    before = fa.flash_attention.launches
    np.testing.assert_array_equal(
        fa.flash_attention(*real).numpy(),
        fa.flash_attention_plain(*real, scale=8 ** -0.5).numpy())
    assert fa.flash_attention.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(*(t.to("meta") for t in real))

    qd, kc, vc = _fakes((2, 4, 8), (2, 32, 2, 8), (2, 32, 2, 8))
    with qd.fake_mode:
        lens = torch.full((2,), 32, dtype=torch.int32, device="meta:0")
    before = fd.flash_decode.launches
    a = analyze_step(lambda *t: fd.flash_decode(*t), qd, kc, vc, lens)
    assert fd.flash_decode.launches == before
    assert a["kernels"]["flash_decode"]["launches"] == [1]
    assert a["kernels"]["flash_decode"]["flops"] == [
        fd.plain_flops(2, 32, 4, 8)]


def test_launches_are_charged_the_plain_versions_flops():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((2, 12, 4, 16), (2, 20, 2, 16), (2, 20, 2, 16)))
    with FlopCounterMode(display=False) as fc:
        fa.flash_attention_plain(q, k, v, scale=0.25)
    assert fc.get_total_flops() == fa.plain_flops(2, 12, 20, 4, 16)
    lens = torch.tensor([5, 20], dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        fd.flash_decode_plain(q[:, 0], k, v, lens, scale=0.25)
    assert fc.get_total_flops() == fd.plain_flops(2, 20, 4, 16)


# -- the production meshes and the records -----------------------------------

def test_production_meshes_are_meta_devices_row_major():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (mesh_chips(one), mesh_chips(two)) == (256, 512)
    assert one.shape == {"data": 16, "model": 16}
    assert two.shape == {"data": 32, "model": 16}
    for mesh in (one, two):
        rows = [[d.index for d in row] for row in mesh.ranks]
        assert all(d.type == "meta" for row in mesh.ranks for d in row)
        # Rows 0, 1 and the last a device a rank; the rows between share.
        own = [list(range(16 * i, 16 * i + 16)) for i in range(4)]
        assert rows[:2] == own[:2] and rows[-1] == own[3]
        assert all(row == own[2] for row in rows[2:-1])
    small = meta_mesh(4, 32)
    assert [d.index for row in small.ranks for d in row] == list(range(128))


@pytest.mark.parametrize("kind,model", [("decode", 2), ("train", 1)])
def test_shared_rows_leave_every_reported_number_exact(kind, model):
    """A (5, model) mesh whose rows 2 and 3 share devices, as a
    production mesh's middle rows do: the rows with devices of their own
    read as on a mesh of five distinct rows, and so does every top-level
    number."""
    dev = lambda k: torch.device("meta", k)
    rows = [tuple(dev(model * i + r) for r in range(model))
            for i in range(4)]
    mesh = DeviceMesh(tuple(rows[:2] + [rows[2]] * 2 + rows[3:]))
    b = build_step(QWEN, ShapeCell("t", kind, 64, 10), mesh,
                   param_dtype=torch.float32)
    shared = analyze_step(b.fn, *b.args_abstract, mesh=mesh)
    full = _dry("qwen3-1.7b", kind, mesh=f"5x{model}", batch=10)
    assert [r["chips"] for r in shared["per_device"]] == \
        [1] * 2 * model + [2] * model + [1] * model
    own = [k for k in range(5 * model) if not 2 * model <= k < 4 * model]
    assert [r for r in shared["per_device"] if r["chips"] == 1] == \
        [full["per_device"][k] for k in own]
    for key in ("flops", "traffic_bytes", "attn_traffic_bytes",
                "collective_bytes", "memory", "traffic_by_kind",
                "collectives"):
        assert shared[key] == full[key], key


JAX_KEYS = {"arch", "shape", "mesh", "kind", "seq", "global_batch",
            "status", "chips", "memory", "collectives", "analysis"}


def test_run_cell_records_ok_skipped_and_error(tmp_path, monkeypatch):
    # A smoke config on a (2, 2) mesh stands in for the production cell.
    get_config = configs.get_config
    with monkeypatch.context() as mp:
        mp.setattr(dryrun.configs, "get_config",
                   lambda arch: get_config(arch, smoke=True))
        mp.setattr(dryrun, "make_production_mesh",
                   lambda multi_pod: meta_mesh(2, 2))
        rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", "pod1",
                              art_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("error")
    assert JAX_KEYS | {"trace_s"} <= set(rec)
    assert not {"lower_s", "compile_s", "cost", "hlo_bytes"} & set(rec)
    assert {"argument_bytes", "output_bytes", "temp_bytes"} <= \
        set(rec["memory"])
    assert "generated_code_bytes" not in rec["memory"]
    assert {"flops", "traffic_bytes", "attn_traffic_bytes",
            "traffic_by_kind", "collective_bytes", "collectives"} <= \
        set(rec["analysis"])
    assert rec["analysis"]["kernels"]["flash_decode"]["launches"] == \
        [QWEN.n_layers] * 4
    assert rec["collectives"]["total_bytes"] == sum(
        c["bytes"] for k, c in rec["collectives"].items()
        if k != "total_bytes")
    path = tmp_path / "qwen3-1.7b__decode_32k__pod1.json"
    assert json.loads(path.read_text()) == rec
    path.unlink()

    rec = dryrun.run_cell("qwen3-1.7b", "long_500k", "pod1",
                          art_dir=str(tmp_path))
    j_cfg = j_configs.get_config("qwen3-1.7b")
    assert rec["status"] == "skipped"
    assert rec["reason"] == j_configs.cell_supported(
        j_cfg, j_configs.SHAPES["long_500k"])[1]

    def broken(*a, **kw):
        raise RuntimeError("a broken cell")

    monkeypatch.setattr(dryrun, "build_step", broken)
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "qwen3-1.7b__decode_32k__pod1.json")
                     .read_text())
    assert rec["status"] == "error"
    assert rec["error"] == "RuntimeError: a broken cell"


def test_the_default_output_is_listed_in_gitignore():
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.normpath(dryrun.ART_DIR) == os.path.join(root,
                                                            "dryrun_torch")
    with open(os.path.join(root, ".gitignore")) as f:
        assert "dryrun_torch/" in f.read().split()
