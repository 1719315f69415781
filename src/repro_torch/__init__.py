"""PyTorch / CUDA port of the DCN accelerator system and its LM serving
substrate, for NVIDIA Hopper.

The JAX package ``repro`` is the reference this package is held against;
this package imports neither it nor JAX. Public layouts match the JAX
package (NHWC activations, HWIO weights; (B, S, H, D) attention
activations). Entry points take ``device=`` and default to ``"cuda"``; the
CUDA kernels under ``csrc/`` build on first use (``kernels._build``), and
on a CPU tensor each kernel wrapper runs its plain torch version instead.

core/      deform reference, TDT, Algorithm-1 host scheduler, simulator,
           fusion planner
kernels/   the fused BLI(+)conv (batch, schedule, tile), standalone BLI,
           TDT and greedy scheduler kernels, flash attention and split-KV
           flash decode; ops (bli_pallas, deformable_conv2d_pallas)
runtime/   graph IR, graph executor (batch_fused / batched / per_tile),
           dcn_pipeline, packing, cache, traces
models/    VGG19 / SegNet DCN configurations; the LM (params, layers,
           transformer, lm: the loss, prefill and the decode step)
configs/   --arch registry of the LM configurations; get_dcn_config
optim/     AdamW over param trees, cosine schedule, clipping; int8 codec
checkpoint/ atomic keep-N async checkpoints in the JAX package's format
data/      synthetic token and image batches, prefetch
serving/   continuous-batching DcnServingEngine with request isolation;
           continuous-batching LM DecodeEngine
launch/    serve: the LM serving command line; steps/train: the LM train
           step and trainer, the DCN trainer; elastic: preemption and
           stragglers; mesh
testing/   deterministic fault injection
obs/       spans, metrics registry, Chrome-trace export
convert    params_from_jax, lm_params_from_jax, opt_state_from_jax: carry
           JAX-package parameters and optimizer state across
"""
