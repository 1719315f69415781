"""PyTorch / CUDA port of the DCN accelerator system, for NVIDIA Hopper.

The JAX package ``repro`` is the reference this package is held against;
this package imports neither it nor JAX. Public layouts match the JAX
package (NHWC activations, HWIO weights). Entry points take ``device=``
and default to ``"cuda"``; the CUDA kernels under ``csrc/`` build on first
use (``kernels._build``), and on a CPU tensor each kernel wrapper runs its
plain torch version instead.

core/      deform reference, TDT, Algorithm-1 host scheduler, simulator,
           fusion planner
kernels/   the fused BLI(+)conv (batch, schedule, tile), standalone BLI,
           TDT and greedy scheduler kernels; ops (bli_pallas,
           deformable_conv2d_pallas)
runtime/   graph IR, graph executor (batch_fused / batched / per_tile),
           dcn_pipeline, packing, cache, traces
models/    VGG19 / SegNet DCN configurations
serving/   continuous-batching DcnServingEngine with request isolation
testing/   deterministic fault injection
obs/       spans, metrics registry, Chrome-trace export
convert    params_from_jax: carry JAX-package parameters across
"""
