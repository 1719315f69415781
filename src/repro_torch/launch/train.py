"""Training drivers: the LM trainer and the paper's DCN trainer.

``train_loop`` / ``main`` (``python -m repro_torch.launch.train --arch
qwen3-1.7b``): data pipeline -> train step -> checkpoints, as the JAX
package's trainer, on one device or over a (data, model) mesh
(``--data-parallel`` / ``--model-parallel``: ``build_step(kind="train")``
with the params and AdamW state placed on the mesh). It resumes from the
newest complete checkpoint (whole leaves, so a run may resume on another
mesh), writes one asynchronously every ``ckpt_every`` steps, handles
SIGTERM preemption and watches for stragglers (``launch.elastic``).

``dcn_train_step`` / ``dcn_train_loop``: the step of the JAX package's
``examples/train_dcn.py`` — a VGG19/SegNet DCN classifier trained on the
synthetic blob images with cross-entropy (``logsumexp - gold``) and AdamW,
the deformable layers through the checkpointed
``fused_deformable_conv2d`` (``fused=True``), a checkpoint every
``ckpt_every`` steps.

Both run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch._tree import value_and_grad
from repro_torch.configs.base import ShapeCell
from repro_torch.data import (DataConfig, PrefetchIterator, image_batch,
                              token_batch)
from repro_torch.launch.elastic import (ElasticConfig, PreemptionGuard,
                                        StragglerDetector)
from repro_torch.launch.mesh import DeviceMesh, make_host_mesh
from repro_torch.launch.steps import build_step, build_train_step
from repro_torch.models import lm
from repro_torch.models.dcn_models import (DcnNetConfig, dcn_net_apply,
                                           init_dcn_net)
from repro_torch.models.params import ShardedTree
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state

def train_loop(cfg, shape: ShapeCell, mesh=None, *, steps: int = 20,
               opt_cfg: AdamWConfig | None = None, ckpt_dir: str | None = None,
               ckpt_every: int = 10, seed: int = 0, log_every: int = 5,
               param_dtype=torch.float32, verbose: bool = True,
               device="cuda"):
    """Train ``cfg`` on ``token_batch`` data of ``shape`` (seq,
    global_batch) up to ``steps``, on ``device``, or over ``mesh`` (a
    ``launch.mesh.DeviceMesh``: the params made on its rank (0, 0) and
    placed by ``build_step``'s specs). -> (params, opt_state, losses of
    the steps this call ran); placed trees over a mesh."""
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    if mesh is None:
        dev = resolve_device(device)
        step_fn = build_train_step(cfg, opt_cfg)
        params = lm.init_lm(cfg, seed, device=dev, dtype=param_dtype)
    else:
        dev = mesh.device(0, 0)
        bundle = build_step(cfg, shape, mesh, opt_cfg=opt_cfg,
                            param_dtype=param_dtype)
        step_fn = bundle.fn
        params = ShardedTree.place(
            lm.init_lm(cfg, seed, device=dev, dtype=param_dtype),
            bundle.param_shardings, mesh)
    opt_state = init_opt_state(params, opt_cfg)

    start_step = 0
    ckptr = None
    if ckpt_dir:
        ckptr = ckpt.AsyncCheckpointer(ckpt_dir)
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            state = ckpt.restore(ckpt_dir, latest,
                                 {"params": params, "opt": opt_state},
                                 device=dev)
            params, opt_state = state["params"], state["opt"]
            start_step = latest
            if verbose:
                print(f"[train] resumed from step {latest}")

    dcfg = DataConfig(seed=seed, vocab=cfg.vocab, seq=shape.seq,
                      global_batch=shape.global_batch,
                      n_codebooks=cfg.n_codebooks,
                      cross_tokens=cfg.n_cross_tokens if cfg.d_cross else 0,
                      cross_dim=cfg.d_cross or 0)
    data = PrefetchIterator(lambda s: token_batch(dcfg, s),
                            start_step=start_step)
    guard = PreemptionGuard()
    straggler = StragglerDetector(ElasticConfig())

    losses = []
    try:
        for _ in range(start_step, steps):
            step_id, batch = next(data)
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0
            if verbose and (step_id % log_every == 0
                            or step_id == steps - 1):
                print(f"[train] step {step_id:5d} loss={loss:.4f} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
            if ckptr and (step_id + 1) % ckpt_every == 0:
                ckptr.save(step_id + 1, {"params": params, "opt": opt_state})
            if straggler.observe(dt) and verbose:
                print(f"[train] straggler detected at step {step_id}; "
                      "re-mesh recommended (launch.elastic)", flush=True)
            if guard.requested:
                if ckptr:
                    ckptr.save(step_id + 1, {"params": params,
                                             "opt": opt_state})
                    ckptr.wait()
                if verbose:
                    print("[train] preemption: checkpointed, exiting 42")
                raise SystemExit(42)
    finally:
        data.close()
    if ckptr:
        ckptr.wait()
    return params, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data-parallel", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    shape = ShapeCell("cli_train", "train", args.seq, args.batch)
    d, m = args.data_parallel, args.model_parallel
    mesh = None
    if d * m > 1:     # as launch.serve maps its mesh
        mesh = make_host_mesh(d, m) \
            if resolve_device(args.device).type == "cuda" \
            else DeviceMesh.on(args.device, data=d, model=m)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    _, _, losses = train_loop(cfg, shape, mesh, steps=args.steps, opt_cfg=opt,
                              ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return losses


# ---------------------------------------------------------------------------
# The DCN trainer
# ---------------------------------------------------------------------------

def dcn_loss(params, cfg: DcnNetConfig, images, labels, *,
             fused: bool = True) -> torch.Tensor:
    """Mean cross-entropy ``logsumexp - gold`` of the classifier."""
    logits = dcn_net_apply(params, cfg, images, fused=fused)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None].long())[:, 0]
    return torch.mean(lse - gold)


def dcn_train_step(params, opt_state, images, labels, cfg: DcnNetConfig,
                   opt_cfg: AdamWConfig, *, fused: bool = True):
    """One AdamW step, written into ``params`` and ``opt_state`` ->
    (params, opt_state, loss)."""
    loss, grads = value_and_grad(
        lambda p: dcn_loss(p, cfg, images, labels, fused=fused), params)
    params, opt_state, _ = adamw_update(params, grads, opt_state, opt_cfg)
    return params, opt_state, loss.detach()


def dcn_train_loop(cfg: DcnNetConfig, *, steps: int = 300, batch: int = 16,
                   lr: float = 3e-4, ckpt_dir: str | None = None,
                   ckpt_every: int = 100, seed: int = 0, fused: bool = True,
                   log_every: int = 25, verbose: bool = True, device="cuda"):
    """Train ``cfg`` from ``init_dcn_net(seed)`` on ``image_batch`` data
    (``batch`` images a step at ``cfg.img_size``, ``cfg.num_classes``
    classes) with the example's AdamW (warm-up 20 steps, cosine over
    ``steps``, weight decay 0.01). -> (params, opt_state, losses)."""
    dev = resolve_device(device)
    params = init_dcn_net(seed, cfg, device=dev)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps,
                          weight_decay=0.01)
    opt_state = init_opt_state(params, opt_cfg)
    dcfg = DataConfig(seed=seed, global_batch=batch)
    ckptr = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    losses = []
    t0 = time.perf_counter()
    for s in range(steps):
        b = image_batch(dcfg, s, img=cfg.img_size, classes=cfg.num_classes)
        params, opt_state, loss = dcn_train_step(
            params, opt_state, torch.as_tensor(b["images"], device=dev),
            torch.as_tensor(b["labels"], device=dev), cfg, opt_cfg,
            fused=fused)
        losses.append(float(loss))
        if verbose and (s % log_every == 0 or s == steps - 1):
            print(f"step {s:4d} loss {losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
        if ckptr and (s + 1) % ckpt_every == 0:
            ckptr.save(s + 1, {"params": params, "opt": opt_state})
    if ckptr:
        ckptr.wait()
    return params, opt_state, losses


if __name__ == "__main__":
    main()
