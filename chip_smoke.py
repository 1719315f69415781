#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          (from the repository root)

Phases, each fatal on failure:

1.  build   — compile ``src/repro_torch/csrc/*.cu`` for sm_90a and load
              them;
2.  kernels — capture the operands of full-width runs of VGG19-3 DCN-II at
              224x224 (a ``batch_fused`` prepass of 4 images, a
              ``batched`` prepass of one image, and the 14x14x512 DCN
              layer through ``ops.deformable_conv2d_pallas`` and
              ``ops.bli_pallas``), then hold each CUDA kernel against its
              plain torch version on those operands (the fused kernels
              within 1e-4 * max|ref|, the BLI kernel within 1e-6 *
              max|ref| in float32 and 2**-7 * max|ref| in bfloat16, the
              TDT, greedy and group scheduling kernels
              bit-exact; the group kernel on every group of the
              batch-fused prepass and on every composite table of the
              batched one, up to (784, 784), also against the per-image
              greedy chain and the numpy ``schedule_tiles``, as is the
              greedy kernel; #2, #3 and the group kernel timed by their
              bare launches into preallocated outputs, their wrappers
              apart, the group kernel beside an empty kernel's launch; the
              split-C kernels #1, #4 and #5 also at their default split
              against ``n_split = 1`` within 1e-5 * max|ref|, each call's
              grid printed) and time kernel, plain version and library
              call (#1 also at other split counts; the BLI kernel #6 at
              the serving shape and at a serving step's four images, each
              in float32 and bfloat16, and on a 56x56x256 plane, each
              beside an empty kernel's launch, a zero_ of its output, and
              its device time from torch.profiler with a cold and a warm
              L2);
3.  serve   — drive ``DcnServingEngine`` (slots=4, tile 8, device
              scheduling) with 8 requests of 1-2 images, one replayed;
              every request must resolve with finite logits that match the
              dense reference, every kernel must have launched (the group
              scheduling kernel at most once per fused group and step), no
              host schedule may be built, no step may retry or degrade, a
              host-scheduled engine must produce identical trace records,
              and every step's trace must equal the DRAM simulator; the
              group kernel is timed on each call shape of the run and
              charged by its launches;
3b. faults  — the same engine with an injected fault: an image-tagged
              dispatch fault fails exactly its request while its
              step-mates resolve through the evicted retry; an untagged
              one degrades the step to per-image ``batched`` dispatch
              through the schedule kernel, whose outputs must match the
              dense reference and ``infer()``; every trace equals the
              simulator; the per-image TDT (#2) and greedy (#3) launches
              of that step are counted, #3 timed per table shape;
3c. modes   — ``run_graph(dispatch="per_tile")`` on one image through the
              tile kernel (logits vs dense, trace == simulator), the
              ``"pallas"`` and ``"pipeline"`` model backends vs dense, and
              ``ops.bli_pallas`` vs ``core.deform.bilinear_sample``;
3d. tune    — an engine with ``autotune="offline"`` (FIFO of 6 tiles, the
              default search budget, plans in a temporary directory)
              searches its plan (search time, evaluations, the tuned
              groups and tiles, tuned <= greedy simulated DRAM) and serves
              phase 3's requests through it: logits vs dense, every step on
              the plan's grids and equal to the simulator, no retry, no
              degraded step; executed DRAM beside a greedy engine at the
              same FIFO depth; a ``cached-only`` engine serves the plan
              from the cache with no search; #1 and the group kernel are
              held against their plain versions on every tuned call shape
              and timed; an untagged fault degrades a tuned step, which
              replays the plan through #4, #2 and #3 and matches
              ``infer()``; images/s beside phase 3's;
3e. scale-out — one process drives a ``DeviceMesh`` that lists this card
              four times: ``run_graph`` of 4 images with ``shard_sizes``
              [2, 1, 0, 1] and with the default split, each bitwise the
              unsharded run, its records and DRAM the simulator's, #1
              launched once per non-empty shard and DCN segment (each
              shard call held against the plain version and timed);
              ``DcnServingEngine(slots=8)`` over the mesh serves phase 3's
              requests (logits vs dense and ``infer()``, every step ==
              simulator, per-replica images, no retry or degraded step),
              and a tagged dispatch fault fails exactly its request;
              images/s beside phase 3's. With two or more cards the same
              ``run_graph`` check runs over ``make_host_mesh`` and prints
              the bytes copied between devices; on one card it prints
              that this sub-run was not run;
4.  profile — one more step under ``torch.profiler``: wall, device busy
              time and idle share, ``cudaLaunchKernel`` and copy calls, and
              the top device activities and host operators;
5.  lm-kernels — hold the flash-attention kernel (#7) against its plain
              version at Qwen3-1.7B prefill shapes, Gemma-2-27B local-layer
              shapes (D=144, window 4096, soft-cap 50) and a ragged
              Sq < Skv case, and the split-KV decode kernel (#8) at Qwen3
              decode shapes (32k cache, ragged lengths) and a Gemma-2
              window + soft-cap case, each within 1e-4 * max|ref|; #8 at two
              split counts within 1e-5 * max|ref|; time kernel, plain
              version and ``scaled_dot_product_attention`` (#7 at the
              prefill's 4 x 2048 and at 2 x 4096, its bound at the 3xTF32
              rate of its tensor-core products with the FP32 one beside);
6.  lm-prefill — Qwen3-1.7B ``full()`` (random weights from the seed,
              float32): ``lm_prefill`` with ``use_flash=True`` on 4 x 2048
              tokens, one #7 launch per layer, last-position logits within
              1e-3 * max|ref| of the ``_sdpa`` path; prefill tokens/s;
7.  lm-serve — ``DecodeEngine(batch=4, max_len=512)`` on the same params
              serves 8 greedy requests (prompts of 16-256 tokens, 32 new
              tokens each), one #8 launch per layer and step; two requests
              cross-checked against ``lm_prefill``; #8 held against its
              plain version on operands kept from the run and timed on
              those of a late step (its serving shape); decode tokens/s,
              step and request latency; 4 more steps under
              ``torch.profiler``;
8.  dcn-train — the phase-3 network's training configuration
              (``get_dcn_config("vgg19", 3)``: DCN-II, 224x224, 1000
              classes) from ``init_dcn_net``, batch 16 of ``image_batch``:
              step 0's loss and gradients with ``fused=True`` (the
              checkpointed ``fused_deformable_conv2d``) held against
              ``fused=False`` within 1e-5 norm-wise per tensor (with
              torch's deterministic kernels; the default atomic
              backward's gap, unfused against itself too, is printed); 5
              AdamW
              steps each way (finite losses, every parameter with a
              gradient moved), p50 step time, images/s and peak memory of
              each; one fused step under ``torch.profiler``; no kernel
              wrapper launched; the ``graph`` backend refuses a gradient
              (the wrappers' grad guard); then the example configuration
              of ``examples/train_dcn_torch.py`` (VGG19-3 at 32x32, width
              0.25, 4 classes, batch 16, lr 3e-4) for 300 steps with a
              checkpoint every 100: the mean loss of the last 50 steps
              below 0.35, the last checkpoint equal to the trained params;
9.  lm-train — Qwen3-1.7B ``full()`` (28 layers, float32 params and AdamW
              state, ``remat="dots"``) for 3 ``build_train_step`` steps of
              B=1 x S=512 ``token_batch`` tokens: finite losses, step
              time, tokens/s and peak memory beside the reckoned p + g +
              m + v; one step profiled; the remat policies ``none``,
              ``full`` and ``dots`` timed one step each with their peak;
              no kernel wrapper launched; then on the ``smoke()``
              config a run resumed from its step-2 checkpoint gives the
              unbroken run's step-3 loss;
10. lm-moe — 10a: granite-moe-3b-a800m ``full()`` (32 layers, d_model
              1536, 24/8 heads x 64, 40 experts padded to 48, top-8,
              expert d_ff 512, vocab 49,155 tied; random float32 weights
              from the seed, ``param_count`` 3,903,166,464): phase 6's
              prefill (4 x 2048, one #7 launch a layer, logits vs the
              ``_sdpa`` path) and phase 7's serving (one #8 launch a layer
              and step, two requests cross-checked against the prefill
              argmax), #7 held and timed on layer 0's prefill operands, #8
              on a late step's; one decode step profiled, and one MoE layer
              at decode timed beside its expert products and the bound of
              reading every expert's weights. 10b: deepseek-v3-671b at
              full width with its depth cut to one dense MLA layer and one
              MLA + MoE layer (256 routed + 1 shared experts, top-8
              sigmoid) plus the MTP block (14,630,393,088 params; the
              whole model, 671,712,677,376, counted on ``meta``): prefill
              1 x 512, a 64-token prompt fed token by token through
              ``lm_decode_step`` (absorbed MLA over a float32 latent cache)
              against ``lm_prefill`` within 1e-3 * max|ref|, and
              ``DecodeEngine`` serving 2 requests of 8 new tokens; no
              kernel wrapper launches on this path. Peak memory of each
              part is printed. 10c: the same weights through
              ``build_step`` over ``DeviceMesh.on("cuda:0", data=1,
              model=4)`` (MLA split by heads, each rank a copy of the
              latent cache; ep 4, nothing drops) beside the unsharded
              path (``mesh_split_run``, ``MESH_SPLIT``): prefill 1 x 512
              within 1e-3 * max|ref|, then 5 decode steps from position
              512 against a 512-row prompt cache (``prompt_cache``) within
              1e-4, step p50 of both, peak memory.
11. lm-recurrent — 11a: jamba-v0.1-52b at full width with its depth cut
              to one period (7 Mamba + 1 attention layer, 4 MoE + 4 dense
              MLPs; 13,295,235,072 params, the whole 51,570,315,264
              counted on ``meta``): phase 6's prefill (one #7 launch, at 4
              query heads a kv head, D 128, held and timed there), phase
              7's serving (one #8 launch a step, held and timed; two
              requests against the prefill argmax with the MoE capacity
              lifted), the decode step profiled beside the bound of its
              weight reads. 11b: xlstm-1.3b ``full()`` whole: prefill 4 x
              2048 with the mLSTM / sLSTM layers' time by CUDA events,
              serving cut to 6 requests of 16-64-token prompts
              (``short_requests``), a decode step profiled; no kernel
              wrapper launches on this path. For both: prompts fed token
              by token through ``lm_decode_step`` against ``lm_prefill``
              (a chunk boundary and a padded tail, 1e-3 * max|ref|), and
              request 0 served again through a used slot gets the greedy
              tokens it got in a fresh slot. Peak memory of each part is
              printed. 11c / 11d: each model's weights through
              ``build_step`` over (2, 2) as 10c (jamba's Mamba split by
              channel, its attention layer's 4 #7 / #8 launches on the
              rank slices held against the plain versions; xlstm's
              mLSTM / sLSTM by head, its limits max(10c's, 2 x the
              logits' move under a one-ulp nudge of every weight),
              prefill 2 x 512.
12. lm-cross — llama-3.2-vision-11b ``full()``, whole (40 layers, the 8
              cross-attention layers at 3, 8, ..., 38 over 1,601 image
              tokens of width 4096; 9,775,157,248 params, 39.1 GB float32
              from the seed), with random float32 image states (4, 1601,
              4096) from a seeded generator (the vision tower is a
              stub): phase 6's prefill with the states (40 #7 launches,
              the 8 cross layers' non-causal; the first and the last
              cross layer's call held against the plain version, the
              non-causal call at 4 x 2048 over 1,601 keys timed beside its
              bounds and SDPA), phase 7's serving with the engine's cross
              cache filled by ``build_cross_cache`` (40 #8 launches a
              step, 8 over the 1,601-row cross cache, held and timed at
              both shapes; two requests against the prefill argmax with
              their slot's image), the decode step profiled beside the
              bound of its weight and cross K/V reads, 2 prompts of 64
              tokens fed token by token through ``lm_decode_step`` over
              the cross cache against ``lm_prefill`` within 1e-3 *
              max|ref|, and the same prompts under another image moving
              the logits by more than 1e-3 * max|ref|. Peak memory of each
              part is printed. 12b: the same weights through
              ``build_step`` over (2, 2) as 10c, the cross layers split by
              head and the ``ShardedCache``'s cross K/V filled by
              ``build_cross_cache`` from each rank's own ``wk`` / ``wv``:
              160 #7 launches in the prefill (32 non-causal) and 160 #8 a
              decode step (32 counted over the ranks' cross caches by
              their rows), each on its rank's cache tensor; #7 and #8 on
              the 4 ranks' slices of the first self-attention layer and
              of the first cross layer held against their plain
              versions, the cross layer's timed.
13. lm-bf16 — 13a: #7's bf16 kernel (Qwen3, granite D 64, Gemma-2 window
              + soft-cap, llama's self and cross layers) and #8 over a
              bf16 cache under a float32 and a bf16 q (the serving shape,
              32k, llama's 1,601-row cross cache, a window with 64 splits
              forced) held against their plain versions (a bf16 output
              within 2**-7 * max|ref|, a float32 one within 1e-4), rerun
              bitwise, and timed beside the float32 kernel, the plain
              version and SDPA in bf16; bounds at the dense bf16 rate
              (#7) and at 2 bytes a cached value (#8). 13b:
              llama-3.2-vision-11b ``full()``, whole, in bf16 (19.55 GB
              from the seed) with random bf16 image states: a float32 run
              of the same weights gives the model's own bf16 error, which
              sets the prefill and decode limits (``BF16_LIMITS``);
              phase 6's prefill (40 #7 launches, 8 non-causal, all on
              bf16 operands), serving (``short_requests``) with
              ``cache_dtype=bfloat16`` (40 #8 launches a step, each on the
              engine's cache tensors themselves, checked by data
              pointer), decode
              vs prefill over the image, the image's effect, a profiled
              prefill and decode step, and peak memory.
14. dcn-bf16 — 14a: #1, #4 and #5 (per tile and whole plane) on phase
              2's operands with x, w and b rounded to bf16, held against
              their plain versions within 2**-7 * max|ref|, rerun
              bitwise, one bf16 launch a call, timed beside the float32
              kernel on the same values widened, the plain version and
              ``torch.matmul`` of the float32 contraction (bounds at 2
              bytes a value and the 3xbf16 rate), and a mixed call (bf16
              x under float32 w and b) through the float32 kernel. 14b:
              VGG19-3 DCN-II at 224x224, 1000 classes, nothing cut, phase
              3's weights rounded to bf16: ``DcnServingEngine.infer`` on
              images 0-11 in batches of 4 and ``run_graph`` batch_fused on
              the same, one image through ``batched`` and ``per_tile``;
              logits against ``run_graph_dense`` in bf16 within
              max(2 eps, 2**-7) * max|ref| (``BF16_DCN``: eps the bf16
              dense path's distance from a float32 run of the same
              weights), every trace at 2 bytes a value equal to the
              simulator, every #1 / #4 / #5 launch a bf16 one, images/s
              of bf16 and float32 ``infer`` in turns and one profiled
              ``infer`` of each (device idle share). 14c (cache-bf16):
              the llama smoke model's bf16 self and cross layer over a
              float32 cache, ``attention_decode`` on the card against the CPU
              path within 2**-7 * max|ref|, and #8's ``round_kv`` over a
              cache within 0.2 ulp of bf16 values against the bf16 cache.
              14d: the same bf16 engine serves 8 single-image requests of
              host bf16 tensors through ``submit`` / ``step()``: logits
              host bf16, bitwise bf16 ``infer`` on the same batches of 4,
              traces at 2 B a value == simulator, every #1 launch bf16,
              images/s beside 14b's; an untagged fault degrades a step to
              per-image ``batched`` dispatch through #4's bf16 body
              (logits within 14b's limit).
15. mesh    — the mesh's "model" axis on this card (a mesh that lists it
              several times: no copy between devices, none measured).
              15a: granite-moe-3b-a800m ``full()`` served by a
              ``DecodeEngine(mesh=DeviceMesh.on("cuda:0", data=1,
              model=16))`` (its ep, 3 experts a rank) in lockstep beside
              an engine without a mesh on the same weights, 2 requests x
              8 new tokens: each step's logits within 1e-4 * max|ref|,
              tokens equal wherever the top-2 gap exceeds 1e-3 *
              max|logits|, step p50 of both and #8 launches a step;
              ``moe_apply(mesh=)`` over (2, 16) in both weight modes at
              the decode shape against the unsharded call (nothing
              drops) and the same call over the CPU mesh. 15b: Qwen3-1.7B
              ``full()`` through ``build_step`` over
              ``DeviceMesh.on("cuda:0", data=2, model=2)``: prefill 4 x
              2048 (28 x 4 #7 launches, logits within 1e-3 * max|ref| of
              the unsharded prefill), 16 decode steps from the prompts'
              K/V (28 x 4 #8 launches a step, each on its rank's cache
              tensor by data pointer; logits within 1e-4 * max|ref|),
              tokens/s beside the unsharded path. 15c: ``python -m
              repro_torch.launch.serve --arch granite-moe-3b-a800m`` on
              ``make_host_mesh(1, 1)`` exits 0.
16. mesh-train — Qwen3-1.7B ``full()``, ``remat="dots"``, 3 AdamW steps
              of 2 x 512 through ``build_step(kind="train")`` over
              ``DeviceMesh.on("cuda:0", data=2, model=2)`` beside the
              unsharded ``build_train_step`` from the same seed and
              batches (run first and freed): losses and every tensor's
              step-0 gradient norm within 1e-4 relative, no hand-written
              kernel launched; step p50 of both, peak memory, one
              profiled mesh step's device idle share.
17. dryrun  — ``launch.op_analysis`` runs Qwen3-1.7B ``full()``'s
              prefill 4 x 2048 and one decode step of 4 over a 2064-row
              bf16 cache on fake tensors over a (2, 2) mesh of ``meta``
              devices; the same steps run on ``DeviceMesh.on("cuda:0", 2,
              2)``: the dry run's #7 / #8 launches equal the wrappers'
              counts (112 each), its aten FLOPs ``FlopCounterMode``'s
              around the real step, each device's argument bytes the
              bytes rank (i, r) holds; the (1, 1) prefill's dry-run peak
              memory within 5 % of ``max_memory_allocated``'s rise.

Each path is driven with every kernel's launch count set to 0 just
before it and read just after. The last lines are the card's name and
power limit, one JSON object with the per-kernel numbers, and
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
N_BATCH = 4
# FP32 CUDA-core peak and dense TF32 tensor-core peak (FLOP/s) and memory
# rate (B/s) by card name, from NVIDIA's data sheets; the SXM part is the
# default.
PEAKS = {"PCIe": (51e12, 378e12, 2.0e12), "NVL": (60e12, 417.5e12, 3.9e12),
         "H200": (67e12, 495e12, 4.8e12)}
PEAK_SXM = (67e12, 495e12, 3.35e12)
FUSED_RTOL = 1e-4     # kernel vs plain: float32 sums in another order
BLI_RTOL = 1e-6       # BLI kernel vs plain / reference: four-term sums
BLI_BF16_RTOL = 2**-7  # bf16 #6 vs plain: one bf16 ulp at the largest output
LOGIT_RTOL = 1e-3     # served vs dense: 16 layers of reordered sums
ATTN_RTOL = 1e-4      # #7 / #8 vs plain: float32 sums in another order
SPLIT_RTOL = 1e-5     # #1 / #4 / #5 / #8 at two split counts: exact combines
# Shapes of the LM phases: (name, B, Sq, Skv, Hq, Hkv, D, options) for #7,
# (name, B, S, Hq, Hkv, D, options) for #8; the first case of each is the
# one timed and reported (#7's first at the shape phase 6 launches it), the
# second #7 case and the first #8 case are timed too and reported under
# their own key ("long_seq", "long_cache").
LM_SIZES = dict(
    arch="qwen3-1.7b", smoke=False,
    flash=[("Qwen3-1.7B prefill", 4, 2048, 2048, 16, 8, 128, {}),
           ("Qwen3-1.7B long prefill", 2, 4096, 4096, 16, 8, 128, {}),
           ("Gemma-2-27B local layer", 1, 6144, 6144, 32, 16, 144,
            dict(window=4096, softcap=50.0)),
           ("ragged Sq < Skv", 2, 1000, 3000, 16, 8, 128, {})],
    decode=[("Qwen3-1.7B decode", 8, 32768, 16, 8, 128, {}),
            ("Gemma-2-27B window + soft-cap", 4, 8192, 32, 16, 144,
             dict(window=4096, softcap=50.0))],
    prefill_batch=4, prefill_len=2048,
    serve_batch=4, serve_max_len=512, requests=8, prompt_len=(16, 256),
    max_new=32, cross_checked=2,
    # The serving runs cut for the script's time (granite 10a, xlstm 11b,
    # llama bf16 13b): 6 requests of 16-64-token prompts, still past step
    # 64 with a stale free slot (148 steps against phase 7's 380).
    short_requests=6, short_prompt_len=(16, 64))
# Phase 10: the MoE / MLA configurations (full widths), their parameter
# counts, and deepseek's prefill, MLA check and served requests.
# granite's serving run is cut (``short_requests``).
MOE_SIZES = dict(granite="granite-moe-3b-a800m", granite_params=3_903_166_464,
                 deepseek="deepseek-v3-671b",
                 deepseek_params=671_712_677_376,
                 deepseek_cut_params=14_630_393_088, ds_prefill=(1, 512),
                 ds_check_len=64, ds_requests=2, ds_prompt_len=(16, 32),
                 ds_max_new=8, ds_max_len=64)
# Phase 11: the recurrent configurations (full widths), their parameter
# counts, and the prompt lengths of the decode-vs-prefill checks (one chunk
# boundary and a padded tail each: jamba's Mamba chunk is 256 steps,
# xlstm's mLSTM chunk 64).
REC_SIZES = dict(jamba="jamba-v0.1-52b", jamba_params=51_570_315_264,
                 jamba_cut_params=13_295_235_072, xlstm="xlstm-1.3b",
                 xlstm_params=1_916_647_760, prefill=(4, 2048),
                 check_batch=2, check_len=dict(jamba=300, xlstm=100))
# Phase 12: the cross-attention configuration (full widths, whole), its
# parameter count, the prefill and the decode-vs-prefill prompts.
CROSS_SIZES = dict(llama="llama-3.2-vision-11b", llama_params=9_775_157_248,
                   prefill=(4, 2048), check=(2, 64))
# Phase 13: bf16 serving. Kernel shapes: (name, B, Sq, Skv, Hq, Hkv, D,
# options) for #7 on bf16 operands; (name, B, S, Hq, Hkv, D, options,
# lengths: "full" or ragged from the seed) for #8 over a bf16 cache, each
# under a float32 and a bf16 q.
BF16_SIZES = dict(
    flash=[("Qwen3-1.7B prefill", 4, 2048, 2048, 16, 8, 128, {}),
           ("granite-moe-3b prefill", 4, 2048, 2048, 24, 8, 64, {}),
           ("Gemma-2-27B local layer", 1, 6144, 6144, 32, 16, 144,
            dict(window=4096, softcap=50.0)),
           ("llama-3.2-vision self layer", 4, 2048, 2048, 32, 8, 128, {}),
           ("llama-3.2-vision cross layer", 4, 2048, 1601, 32, 8, 128,
            dict(causal=False))],
    decode=[("Qwen3-1.7B serving shape", 4, 512, 16, 8, 128, {}, "ragged"),
            ("Qwen3-1.7B 32k cache", 8, 32768, 16, 8, 128, {}, "ragged"),
            ("llama-3.2-vision self layer", 4, 512, 32, 8, 128, {},
             "ragged"),
            ("llama-3.2-vision cross cache", 4, 1601, 32, 8, 128, {},
             "full"),
            ("Gemma-2-27B window + soft-cap, 64 splits forced", 4, 8192, 32,
             16, 144, dict(window=4096, softcap=50.0, num_splits=64),
             "ragged")])
# Two bf16 ulps at the largest output: #7 / #8 with a bf16 output against
# the plain version (both float32 inside, the output rounded once; #7 also
# rounds P to bf16 for P V).
BF16_RTOL = 2.0 ** -7
# One float16 ulp at the largest output, phase 18's limit for a float16
# output against the plain version (both float32 inside, the output
# rounded once; #7 also rounds P to float16 for P V).
F16_RTOL = 2.0 ** -10
# Phase 13's model-level limits (PERF.md §2, written before its first
# run). A random-weight 40-layer model in bf16 moves its logits by a few
# per cent of max|logits| from rounding alone, so the prefill and decode
# limits are read from the model's own bf16 error: ``noise_factor`` times
# the bf16 path's distance from the float32 run of the same bf16 weights
# (never below BF16_RTOL); a token may differ from the prefill argmax only
# within the prefill limit of its top-2 gap. ``image``: another image must
# move the bf16 logits by more than this share of max|logits| (a cross
# path that ignored the image would give bitwise-equal logits).
BF16_LIMITS = dict(noise_factor=2.0, image=BF16_RTOL)
# Phase 14: bf16 DCN serving. 14b's logits limit (PERF.md §2, written
# before its first run): max(noise_factor x eps, BF16_RTOL) of max|ref|,
# eps the bf16 dense path's distance from a float32 run of the same bf16
# weights and images over max|ref32| (the network's own bf16 error).
# ``batches``: the images of phase 3's requests in serving steps of 4;
# ``turns``: rounds of float32 and bf16 ``infer`` timed in turns (f, b,
# b, f), each on a fresh engine.
BF16_DCN = dict(noise_factor=2.0, batches=[(0, 4), (4, 8), (8, 12)],
                warm=(12, 16), one=(14, 15), turns=4, step_images=(0, 8))
# 14c: the llama-3.2-vision smoke model's layers over a float32 cache.
BF16_CACHE = dict(arch="llama-3.2-vision-11b", batch=3, max_len=300,
                  pos=(0, 170, 299))
# Phase 8 / 9: training sizes.
TRAIN_SIZES = dict(dcn_batch=16, dcn_steps=5, example_steps=300,
                   example_tail=50, example_limit=0.35, lm_arch="qwen3-1.7b",
                   lm_batch=1, lm_seq=512, lm_steps=3)
GRAD_RTOL = 1e-5      # fused vs unfused gradients, norm-wise per tensor
# Phase 15: the mesh's "model" axis on this one card (PERF.md §2 holds the
# limits, written before its first run). 15a: granite served by a
# DecodeEngine over a (1, 16) mesh beside an unsharded one, moe_apply held
# over (2, 16); 15b: Qwen3-1.7B through build_step over (2, 2).
MESH_SIZES = dict(granite="granite-moe-3b-a800m", ep_mesh=(1, 16),
                  moe_mesh=(2, 16), requests=2, prompt_len=4, max_new=8,
                  max_len=32, step_rtol=1e-4, gap_rtol=1e-3,
                  qwen="qwen3-1.7b", tp_mesh=(2, 2), prefill=(4, 2048),
                  decode_steps=16, decode_rtol=1e-4, held_step=4,
                  aux_rtol=1e-5)
# Phases 10c, 11c, 11d and 12b: each family's own weights through
# build_step over DeviceMesh.on("cuda:0", data, model) beside the unsharded
# path, with MLA, Mamba, mLSTM / sLSTM and cross-attention split over
# "model" (PERF.md §2 holds the limits): prefill (B, S), then
# ``decode_steps`` steps from position S against an S-row prompt cache.
# xlstm's limits are read from the model's own float32 conditioning
# (``nudge``): each is max(its fixed limit, nudge x how far the unsharded
# logits move when every weight moves by at most one ulp). On the H100
# the random-weight 48-layer xlstm moves its prefill by 1.5e-3 of
# max|ref| over the mesh, and its own decode-vs-prefill check (11b)
# reads 8.1e-4: float32 sums in another order move it that far.
MESH_SPLIT = dict(
    deepseek=dict(mesh=(1, 4), prefill=(1, 512)),
    jamba=dict(mesh=(2, 2), prefill=(2, 512)),
    xlstm=dict(mesh=(2, 2), prefill=(2, 512), decode_rtol=1e-3, nudge=2.0),
    llama=dict(mesh=(2, 2), prefill=(2, 512)),
    decode_steps=5, prefill_rtol=1e-3, decode_rtol=1e-4)
# Phase 16: Qwen3-1.7B training over DeviceMesh.on("cuda:0", 2, 2) beside
# the unsharded step (PERF.md §2 holds the limit, written before its first
# run).
MESH_TRAIN = dict(arch="qwen3-1.7b", mesh=(2, 2), batch=2, seq=512,
                  steps=3, lr=1e-4, rtol=1e-4)
# Phase 17: the dry run (``launch.op_analysis`` on a mesh of meta devices)
# of Qwen3-1.7B beside the same steps run on DeviceMesh.on("cuda:0", 2, 2)
# (phase 15b's cell; PERF.md §2 holds the limit, written before its first
# run): prefill (B, S), one decode step of B over an S-row cache.
DRYRUN = dict(arch="qwen3-1.7b", mesh=(2, 2), prefill=(4, 2048),
              decode=(4, 2064), mem_rtol=0.05)
# Phase 18: float16 (PERF.md §2 holds the limits, written before its first
# run). 18a: #7 at phase 13a's shapes and #8 at ``decode``'s, in float16;
# #1 / #4 / #5 / #6 on phase 2's operands rounded to float16; every
# float16 output within F16_RTOL * max|ref| of the plain version (a
# float32 one, #8 under a float32 q, within 1e-4). 18b: VGG19-3 in
# float16, BF16_DCN's rule with the floor F16_RTOL. 18c: Qwen3-1.7B
# ``full()`` in float16 (phase 6's prefill, phase 7's requests over a
# float16 cache): prefill and token limits max(noise_factor x eps,
# F16_RTOL), eps the float16 ``_sdpa`` path's distance from a float32 run
# of the same float16 weights; ``layer``: one layer over a float32 cache
# (B, S, positions; 14c's rule: within 1e-5 of the float16 cache, the
# unrounded read moving it by more). 18d: the general bodies of #7 / #8
# at ``any_flash`` / ``any_decode`` in float32, bf16 and float16 (each
# within ATTN_RTOL / BF16_RTOL / F16_RTOL of its plain version; D 1536 and
# 2048 past the tensor-core body's shared memory, on the wide path; each
# decode shape's lengths drawn once for the three types), one view
# off a 16-byte boundary each, a float32 q over a bf16 and a float16 cache
# at ``timed_decode``'s shape (ATTN_RTOL), and a bf16 cache of B * Hkv =
# 65,536 at a few rows (``many_pairs``); ``timed_flash`` / ``timed_decode``
# name the shapes of the two general bodies' JSON entries, timed in all
# three types.
F16_SIZES = dict(
    decode=("Qwen3-1.7B serving shape", "Qwen3-1.7B 32k cache",
            "llama-3.2-vision cross cache"),
    noise_factor=2.0,
    layer=(4, 512, (511, 300, 64, 1)),
    any_flash=[("D 6", 1, 300, 300, 8, 2, 6, {}),
               ("D 72, window", 1, 300, 300, 8, 2, 72, dict(window=64)),
               ("D 160, soft-cap", 1, 300, 300, 8, 2, 160,
                dict(softcap=30.0)),
               ("Gemma-7B D 256", 1, 2048, 2048, 16, 16, 256, {}),
               ("D 320, window + soft-cap, non-causal", 2, 200, 333, 8, 1,
                320, dict(window=100, softcap=50.0, causal=False)),
               ("D 1536, window", 1, 200, 200, 4, 2, 1536,
                dict(window=64))],
    any_decode=[("D 6", 4, 512, 8, 2, 6, {}),
                ("D 100, window", 4, 512, 8, 2, 100, dict(window=200)),
                ("D 320, soft-cap", 4, 512, 8, 2, 320, dict(softcap=30.0)),
                ("group 16 over 1 kv head", 4, 1024, 16, 1, 128, {}),
                ("Falcon-7B group 71 over 1 kv head", 4, 2048, 71, 1, 64,
                 {}),
                ("D 2048", 4, 300, 4, 2, 2048, {})],
    many_pairs=(8192, 8, 8, 16, 16),       # B, Hkv, Hq, S, D
    timed_flash="Gemma-7B D 256", timed_decode=(
        "Falcon-7B group 71 over 1 kv head"))
# Device cycles the stream sleeps before each timed window, so the host
# enqueues the window's launches while the device is still busy and the
# events time the device work, not the host's launch overhead.
HOLD_CYCLES = 1_000_000
# Empty launches that open a profiled window of #6. Late in this script's
# run the profiler has returned windows without their first device
# records: 5 of 60 to all 40 (tools/profiler_windows.py; phase 18a), the
# same with the device idle for 0.1 s at both ends of the window. The
# lead-in takes that loss in the timed calls' place.
PROFILE_LEAD = 1024


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


_FLUSH = []


def cuda_time_ms(fn, iters: int, warmup: int = 2, cold: bool = True
                 ) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each timed by CUDA
    events after a write of 128 MB that evicts the 50 MB L2 cache — the
    serving path finds its operands cold — (skipped when not ``cold``) and
    a device sleep that lets the host enqueue the window before the device
    reaches it."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.empty(32 << 20, dtype=torch.float32,
                                  device="cuda"))
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        if cold:
            _FLUSH[0].zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


@contextlib.contextmanager
def recording(module, name: str, store: list, keep=None):
    """Stand a recording shim in for ``module.name`` (a kernel wrapper as
    its caller looks it up): each call's arguments go to ``store`` and the
    wrapper itself, launch counter included, runs unchanged. With
    ``keep``, only the calls for which ``keep()`` holds when they return
    are stored, as ``(args, kwargs, result)`` with every tensor copied, so
    that a caller that later writes an operand in place (a decode step
    writes its cache) does not change what was stored."""
    orig = getattr(module, name)

    def copy(x):
        return x.clone() if hasattr(x, "clone") else x

    def shim(*a, **k):
        if keep is None:
            store.append((a, k))
            return orig(*a, **k)
        out = orig(*a, **k)
        if keep():
            store.append(([copy(x) for x in a],
                          {n: copy(x) for n, x in k.items()}, copy(out)))
        return out

    setattr(module, name, shim)
    try:
        yield
    finally:
        setattr(module, name, orig)


def profiled_window(fn, kernel: str, n: int, cold: bool, lead: int
                    ) -> tuple[list[float], int]:
    """One torch.profiler window (CPU and CUDA activity) of ``lead`` empty
    launches, then ``n`` calls of ``fn`` timed as ``cuda_time_ms`` times
    them: the device durations (us) of the activities whose name holds
    ``kernel``, and the count of the window's device records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            torch.cuda._sleep(0)
        cuda_time_ms(fn, n, warmup=0, cold=cold)
    _, by_name = device_busy(prof.events())
    return ([t for name, ts in by_name.items() if kernel in name
             for t in ts], sum(len(ts) for ts in by_name.values()))


def rel_err(got, ref) -> tuple[float, float]:
    """(max|got - ref|, max|ref|)."""
    return (float((got - ref).abs().max()), float(ref.abs().max()))


def device_busy(events) -> tuple[float, dict[str, list[float]]]:
    """Device busy time (us) of a profiler trace — the union of the
    intervals of its device-side activities (kernels, copies, memsets),
    so that nothing is counted twice — and each activity's durations by
    name. Host operators also carry device time in ``key_averages()``,
    which is why the events themselves are read."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        by_name.setdefault(e.name, []).append(
            e.time_range.end - e.time_range.start)
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy, by_name


def profile_step(eng, batch, card: str) -> None:
    """One serving step of 4 unseen images under ``torch.profiler``: the
    step's wall time, the device's busy time and idle share, the top
    device activities and the top host operators by self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng.submit(batch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = eng.drain()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if len(done) != 1 or done[0].error is not None:
        fail("the profiled step did not resolve cleanly")
    busy_us, by_name = device_busy(prof.events())
    if busy_us <= 0:
        fail("the profiler recorded no device activity in a serving step")
    tr = eng.last_trace
    print(f"[profile] {card}: one step of {len(batch)} unseen images: wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"(idle {100 * (1 - busy_us / wall_us):.1f} %), host prepass "
          f"{tr.overlap.prepass_s * 1e3:.1f} ms of which the execute "
          f"loop waited {tr.overlap.prepass_wait_s * 1e3:.1f} ms, "
          f"schedule build {tr.overlap.schedule_s * 1e3:.1f} ms")
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key.startswith(("cudaLaunch", "cudaMemcpy"))}
    print(f"[profile] host runtime calls in the step: " + ", ".join(
        f"{k} {v}" for k, v in sorted(calls.items())))
    for name, d in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]:
        print(f"  device {sum(d) / 1e3:8.2f} ms x{len(d):<5d} {name[:90]}")
    for e in sorted(prof.key_averages(),
                    key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        print(f"  host   {e.self_cpu_time_total / 1e3:8.2f} ms "
              f"x{e.count:<5d} {e.key[:90]}")


def live_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs the flash mask leaves visible."""
    import numpy as np
    qi = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(qi + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(qi - window + 1, 0) if window is not None else 0
    return int(np.clip(hi - lo, 0, None).sum())


def sdpa_yardstick(q, k, v, **kw):
    """``scaled_dot_product_attention`` on (B, H, S, D) operands with the
    kv heads grouped (``enable_gqa``): the library yardstick only, the
    port never calls it."""
    import torch.nn.functional as F
    return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                  **kw)


def hold(what, got, ref, rtol):
    """Fail unless ``got`` is finite and within ``rtol * max|ref|`` of
    ``ref``; -> (max|got - ref|, max|ref|)."""
    import torch
    torch.cuda.synchronize()
    d, sc = rel_err(got, ref)
    if not torch.isfinite(got).all() or not d <= rtol * sc:
        fail(f"{what}: max|d|={d} > {rtol}*{sc} (or not finite)")
    return d, sc


def hold_captured(what, calls, plain, rtol=ATTN_RTOL):
    """Hold each captured ``(args, kwargs, result)`` of a path against
    ``plain`` on the same operands, within ``rtol`` * max|ref|."""
    for a, k, out in calls:
        k = dict(k, scale=k.get("scale") or a[0].shape[-1] ** -0.5)
        yield hold(what, out, plain(*a, **k), rtol)


def time_flash(q, k, v, opts, err, name) -> dict:
    """#7 on (q, k, v), its plain version and the SDPA yardstick, timed;
    the work and bytes its bound is computed from."""
    from repro_torch.kernels import flash_attention as fa

    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    causal = opts.get("causal", True)
    tiles = fa.tile_config(d)
    n_qt = -(-sq // tiles["block_q"])
    grid = f"({n_qt * b * hq},) = {n_qt} query tiles x {b * hq} rows"
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = sdpa_yardstick(qt, kt, vt, is_causal=causal)
    live = live_pairs(sq, skv, causal, opts.get("window"))
    # Both products run in 3xTF32 on the tensor cores; the FP32 CUDA-core
    # bound of the same work is kept beside it.
    flops = 4 * b * hq * live * d
    return dict(
        max_abs_err=err,
        ms=cuda_time_ms(lambda: fa.flash_attention(q, k, v, **opts), 10),
        plain_ms=cuda_time_ms(lambda: fa.flash_attention_plain(
            q, k, v, scale=d ** -0.5, **opts), 2, warmup=1),
        library_ms=cuda_time_ms(lib, 5),
        ops={"3xtf32": flops}, fp32_ops=flops,
        bytes=4 * (2 * q.numel() + k.numel() + v.numel()),
        shape=f"{name} B={b} S={sq}"
              f"{'' if skv == sq else f' Skv={skv}'} Hq={hq} Hkv={hkv} "
              f"D={d}, {'causal' if causal else 'non-causal'} (live share "
              f"{live / (sq * skv):.4f}), grid {grid}, {tiles['block_q']} x "
              f"{tiles['block_k']} tiles")


def attn_specs(cfg) -> list:
    """The block specs of the model's GQA attention layers (one #7 / #8
    launch each), cross-attention layers included, in launch order."""
    specs = cfg.prefix + cfg.pattern * cfg.n_repeats
    return [s for s in specs if s.kind == "attn"]


def attn_layers(cfg) -> int:
    return len(attn_specs(cfg))


def cross_layers(cfg) -> list[int]:
    """Indices among the attention layers of the cross-attention ones."""
    return [i for i, s in enumerate(attn_specs(cfg)) if s.cross]


@contextlib.contextmanager
def tallied(module, name: str, key, tally: dict):
    """Count each call of ``module.name`` in the block under
    ``key(args, kwargs)`` in ``tally``."""
    orig = getattr(module, name)

    def shim(*a, **k):
        out = orig(*a, **k)
        tally[key(a, k)] = tally.get(key(a, k), 0) + 1
        return out

    setattr(module, name, shim)
    try:
        yield
    finally:
        setattr(module, name, orig)


def prefill_through_flash(card, tag, params, cfg, toks, reset_counts,
                          cross_states=None, logit_rtol=LOGIT_RTOL,
                          attn_rtol=ATTN_RTOL):
    """``lm_prefill`` of ``toks`` (and ``cross_states``, the image states
    of a cross-attention model) with ``use_flash``: one #7 launch an
    attention layer, non-causal in each cross layer, last-position logits
    within ``logit_rtol`` (a number, or a function of the ``_sdpa`` path's
    logits that gives one) of the ``_sdpa`` path, the #7 operands of the
    first and the last attention layer and of the first and the last cross
    layer held against the plain version within ``attn_rtol``. -> (#7
    launches, [(args, kwargs, out)] of those calls in layer order, the
    prefill's wall time in s, the non-causal launches)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers, lm

    sync = torch.cuda.synchronize
    pb, plen = toks.shape
    n_attn, cross = attn_layers(cfg), cross_layers(cfg)
    ends = sorted({0, n_attn - 1, *cross[:1], *cross[-1:]})
    cfg_flash = dataclasses.replace(cfg, use_flash=True)

    def batch(t):
        return {"tokens": t} if cross_states is None else \
            {"tokens": t, "cross_states": cross_states}

    lm.lm_prefill(params, cfg_flash, batch(toks[:, :64]))        # warm-up
    sync()
    held7, modes = [], {}
    reset_counts()
    t0 = time.perf_counter()
    with tallied(layers, "flash_attention",
                 lambda _, k: "causal" if k.get("causal", True) else
                 "non-causal", modes), \
            recording(layers, "flash_attention", held7, keep=lambda: (
                fa.flash_attention.launches - 1 in ends)):
        logits = lm.lm_prefill(params, cfg_flash, batch(toks))
    sync()
    wall = time.perf_counter() - t0
    n7 = fa.flash_attention.launches
    n_nc = modes.get("non-causal", 0)
    if n7 != n_attn or n_nc != len(cross):
        fail(f"prefill launched flash_attention {n7} times ({modes}), "
             f"expected one per attention layer ({n_attn}), non-causal in "
             f"the {len(cross)} cross layers")
    t0 = time.perf_counter()
    ref = lm.lm_prefill(params, cfg, batch(toks))
    sync()
    wall_ref = time.perf_counter() - t0
    if tuple(logits.shape) != (pb, cfg.n_codebooks, cfg.vocab):
        fail(f"prefill logits {tuple(logits.shape)}")
    if callable(logit_rtol):
        logit_rtol = logit_rtol(ref)
    d, sc = hold("prefill logits (flash vs _sdpa path)", logits, ref,
                 logit_rtol)
    print(f"[{tag}] {card}: {pb} x {plen} tokens through "
          f"{n7} flash_attention launches ({n_nc} non-causal) in "
          f"{wall * 1e3:.1f} ms = "
          f"{pb * plen / wall:.0f} prefill tokens/s (_sdpa path "
          f"{wall_ref * 1e3:.1f} ms); last-position logits finite, max|d| "
          f"{d:.3e} (limit {logit_rtol:.4g}*{sc:.3f})")
    del logits, ref
    if len(held7) != len(ends):
        fail(f"kept {len(held7)} prefill calls of flash_attention, not "
             f"{len(ends)}")
    for layer, (a, k, _), (d, sc) in zip(
            ends, held7, hold_captured(
                "flash_attention on the prefill's operands", held7,
                fa.flash_attention_plain, attn_rtol)):
        print(f"[{tag}] flash_attention on the prefill's operands at "
              f"{'cross' if layer in cross else 'attention'} layer {layer} "
              f"of {n_attn} (q {tuple(a[0].shape)} {a[0].dtype}, k "
              f"{tuple(a[1].shape)}, {k}) vs plain: max|d| {d:.3e} (limit "
              f"{attn_rtol:.4g}*{sc:.3f})")
    torch.cuda.empty_cache()
    return n7, held7, wall, n_nc


def short_requests(cfg):
    """The cut serving runs' requests (``LM_SIZES["short_requests"]``)."""
    return serving_requests(cfg, LM_SIZES["short_requests"],
                            LM_SIZES["short_prompt_len"])


def serving_requests(cfg, n=None, prompt_len=None):
    """Phase 7's greedy requests (``LM_SIZES``), drawn from the seed; ``n``
    requests of ``prompt_len`` (lo, hi) tokens where given."""
    import numpy as np

    from repro_torch.serving import Request

    sizes = LM_SIZES
    srng = np.random.default_rng(SEED + 7)
    lo, hi = prompt_len or sizes["prompt_len"]
    reqs = []
    for rid in range(n or sizes["requests"]):
        plen_r = int(srng.integers(lo, hi + 1))
        reqs.append(Request(rid=rid, max_new=sizes["max_new"],
                            prompt=srng.integers(0, cfg.vocab, size=plen_r)
                            .tolist()))
    return reqs


def serve_timed(eng, reqs):
    """Submit ``reqs`` and step ``eng`` until idle. -> (step latencies in
    s, finish time of each rid in s from the start, wall s)."""
    import torch

    for r in reqs:
        eng.submit(r)
    step_s, finish_s = [], {}
    t0 = time.perf_counter()
    while len(step_s) < 100_000:
        ts = time.perf_counter()
        active = eng.step()
        now = time.perf_counter()
        step_s.append(now - ts)
        for r in eng.finished:
            finish_s.setdefault(r.rid, now - t0)
        if active == 0 and not eng.queue:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [r.rid for r in reqs if not r.done or len(r.out) != r.max_new]
    if bad:
        fail(f"requests {bad} did not finish with max_new tokens")
    return step_s, finish_s, wall


def serving_line(reqs, eng, step_s, finish_s, wall) -> str:
    """Decode tokens/s, step and request latency of one serving run."""
    import numpy as np

    n_tok = sum(len(r.out) for r in reqs)
    lat = np.asarray(sorted(finish_s[r.rid] for r in reqs))
    st = np.asarray(step_s[:eng.steps])
    return (f"{len(reqs)} requests (prompts {[len(r.prompt) for r in reqs]})"
            f" served in {eng.steps} steps of batch {eng.batch}; {n_tok} new "
            f"tokens in {wall:.2f} s = {n_tok / wall:.1f} decode tokens/s "
            f"({eng.steps * eng.batch / wall:.1f} slot-tokens/s incl. the "
            f"prompts); step latency p50 {np.percentile(st, 50) * 1e3:.2f} ms"
            f" p99 {np.percentile(st, 99) * 1e3:.2f} ms; request latency p50 "
            f"{np.percentile(lat, 50):.2f} s p99 {np.percentile(lat, 99):.2f}"
            f" s")


def decode_splits(kc, lengths, opts) -> str:
    """How #8 cuts a call's sequences: over a float32 cache the split
    count a sequence (``split_ranges`` under ``default_splits``), over a
    bf16 one the cluster size and the blocks with keys a sequence
    (``cluster_ranges``)."""
    import torch

    from repro_torch.kernels import flash_decode as fd

    b, s, hkv, _ = kc.shape
    w, n = opts.get("window"), opts.get("num_splits")
    if kc.dtype == torch.bfloat16:
        c = fd.cluster_size(b, hkv, s, num_splits=n)
        per = [len(r) for r in fd.cluster_ranges(lengths, s, c, w, n)]
        return (f"clusters of {c} blocks, {c * b * hkv} blocks, blocks "
                f"with keys {per}")
    cap = n or fd.default_splits(b, hkv, s)
    per = [len(r) for r in fd.split_ranges(
        lengths, s, cap, hkv, w, None if n else fd._BLOCKS_PER_SM
        * fd.H100_SMS)]
    return f"splits {per} of at most {cap}"


def time_decode(call, n_split, shape) -> dict:
    """#8 on a captured ``(args, kwargs, out)`` call, its plain version and
    the SDPA yardstick, timed; the work and bytes its bound is computed
    from (the keys visible to it)."""
    import torch

    from repro_torch.kernels import flash_decode as fd

    a8, k8, _ = call
    k8 = dict(k8, scale=k8.get("scale") or a8[0].shape[-1] ** -0.5)
    q8, kc8, vc8, lens8 = a8
    b8, s8, hkv8, d8 = kc8.shape
    vis8 = sum(hi - lo for seq in fd.split_ranges(
        lens8.tolist(), s8, n_split, hkv8, k8.get("window"))
        for lo, hi in seq)
    ki8 = torch.arange(s8, device=kc8.device)[None, :]
    mask8 = ki8 < lens8[:, None].long()
    if k8.get("window") is not None:
        mask8 &= ki8 > lens8[:, None].long() - 1 - k8["window"]
    kt8, vt8 = (t.transpose(1, 2).contiguous() for t in (kc8, vc8))
    lib8 = sdpa_yardstick(q8[:, :, None], kt8, vt8,
                          attn_mask=mask8[:, None, None, :],
                          scale=k8["scale"])
    return dict(
        ms=cuda_time_ms(lambda: fd.flash_decode(*a8, **k8), 200),
        plain_ms=cuda_time_ms(lambda: fd.flash_decode_plain(*a8, **k8), 50),
        library_ms=cuda_time_ms(lib8, 200),
        ops=dict(fp32=4 * vis8 * q8.shape[1] * d8),
        bytes=kc8.element_size() * 2 * vis8 * hkv8 * d8
        + q8.element_size() * 2 * q8.numel() + 4 * b8,
        shape=f"{shape}, B={b8} S={s8} Hq={q8.shape[1]} Hkv={hkv8} D={d8}, "
              f"lengths {lens8.tolist()}, {vis8} visible keys, "
              f"{decode_splits(kc8, lens8.tolist(), k8)}")


def cache_kv_ptrs(cache) -> set:
    """The data pointers of every attention layer's K and V cache in
    ``cache``, a stacked leaf's per-layer views included: where #8 must
    read a cache from, not from a copy."""
    import torch

    ptrs = set()

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"k", "v"}:
                for t in node.values():
                    if t is None:        # a ShardedCache rank holding none
                        continue
                    ptrs.update([t.data_ptr()] if t.dim() == 4 else
                                [r.data_ptr() for r in torch.unbind(t, 0)])
                return
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(cache)
    return ptrs


def prompt_cache(cfg, b, max_len, fill, seed):
    """A whole float32 decode cache of ``b`` rows on the card as a prefill
    of ``fill`` tokens leaves it: every self-attention layer's K / V and
    every MLA layer's latent hold ``fill`` rows of seeded normal values
    (the weights are random, and so are the rows a prompt writes), the
    recurrent states their initial values, the cross caches empty.
    Decode from ``pos = fill`` then reads each cache at the prompt's
    length."""
    import torch

    from repro_torch.models import lm

    cache = lm.init_cache(cfg, b, max_len, dtype=torch.float32,
                          device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def fill_rows(t, seq_dim):
        rows = t.narrow(t.dim() + seq_dim, 0, fill)
        rows.copy_(torch.randn(rows.shape, generator=gen, device=t.device))

    def walk(node):
        if isinstance(node, list):
            for v in node:
                walk(v)
        elif set(node) == {"k", "v"}:
            for t in node.values():
                if t.shape[-3] == max_len:        # not a cross layer's
                    fill_rows(t, -3)
        elif set(node) == {"ckv"}:
            fill_rows(node["ckv"], -2)
        else:
            for v in node.values():
                if isinstance(v, (dict, list)):
                    walk(v)

    walk(cache)
    return cache


def mesh_split_run(card, tag, params, cfg, family, kernels=None,
                   cross_states=None) -> None:
    """``params`` of ``cfg`` (the phase's own weights) through
    ``build_step`` over ``DeviceMesh.on("cuda:0", data, model)``
    (``MESH_SPLIT[family]``) beside the unsharded path on the same
    inputs: every mixer whose specs split it over "model" runs over the
    ranks, each on its own slices (views: one card, no copy). Prefill
    logits within ``prefill_rtol`` * max|ref|; then ``decode_steps``
    steps from position ``plen`` against a ``prompt_cache`` of ``plen``
    rows (cut by ``shard_cache`` for the mesh; a cross model's cross
    caches filled by ``build_cross_cache``, on the mesh from the placed
    params) within ``decode_rtol`` * max|ref| a step. Every attention
    layer launches #7 once a row and rank, non-causal in the cross
    layers, and #8 once a row and rank a step, each on its rank's cache
    tensor (by data pointer), the cross layers' counted by their cache's
    rows. #7 and #8 on the ranks' slices of the first self-attention
    layer and the first cross layer (the last step's) are held against
    their plain versions; with ``kernels``, the cross layer's are timed
    into their ``shapes``. Prints the step p50 of both paths and the peak
    memory."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models import layers, lm
    from repro_torch.models.params import ShardedTree
    from repro_torch.models.transformer import cache_split, shard_cache

    sz, sync = MESH_SPLIT, torch.cuda.synchronize
    d, m = sz[family]["mesh"]
    pb, plen = sz[family]["prefill"]
    steps = sz["decode_steps"]
    max_len = plen + steps
    prefill_rtol = sz["prefill_rtol"]
    decode_rtol = sz[family].get("decode_rtol", sz["decode_rtol"])
    if cfg.moe is not None:        # ep = the model size; nothing drops
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            no_drops(cfg).moe, ep=m))
    cfg = dataclasses.replace(cfg, use_flash=True)
    dev = torch.device("cuda")
    mesh = DeviceMesh.on("cuda:0", data=d, model=m)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pre = build_step(cfg, ShapeCell("p", "prefill", plen, pb), mesh,
                     param_dtype=torch.float32)
    dec = build_step(cfg, ShapeCell("d", "decode", max_len, pb), mesh,
                     param_dtype=torch.float32)
    placed = ShardedTree.place(params, pre.param_shardings, mesh)
    split = cache_split(placed["layers"], cfg)
    rng = np.random.default_rng(SEED + 22)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(
        pb, plen + steps)).astype(np.int32), device=dev)
    batch = {"tokens": toks[:, :plen]}
    if cross_states is not None:
        batch["cross_states"] = cross_states[:pb]
    n_attn, cross = attn_layers(cfg), cross_layers(cfg)
    n_rk = d * m
    ref_cache = prompt_cache(cfg, pb, max_len, plen, SEED + 24)
    pos0 = torch.full((pb,), plen, dtype=torch.int32, device=dev)
    if sz[family].get("nudge"):
        prefill_rtol, decode_rtol = nudged_limits(
            tag, params, cfg, batch, toks[:, plen:], ref_cache, pos0,
            sz[family]["nudge"], prefill_rtol, decode_rtol)
    # The attention layers whose rank calls are held against the plain
    # versions: the first self-attention layer and the first cross layer.
    selfs = [j for j in range(n_attn) if j not in cross]
    watch = sorted({selfs[0] if selfs else -1, cross[0] if cross else -1}
                   - {-1})

    def calls_at(held, j):
        k = watch.index(j)
        return held[k * n_rk:(k + 1) * n_rk]

    pre.fn(placed, {k: v[:, :16] if k == "tokens" else v
                    for k, v in batch.items()})               # warm-up
    sync()
    held7, modes = [], {}
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    with tallied(layers, "flash_attention",
                 lambda _, k: "causal" if k.get("causal", True) else
                 "non-causal", modes), \
            recording(layers, "flash_attention", held7, keep=lambda: (
                (fa.flash_attention.launches - 1) // n_rk in watch)):
        got = pre.fn(placed, batch)
    sync()
    wall = time.perf_counter() - t0
    n7 = fa.flash_attention.launches
    n_nc = modes.get("non-causal", 0)
    if n7 != n_attn * n_rk or n_nc != len(cross) * n_rk:
        fail(f"{tag} mesh prefill launched flash_attention {n7} times "
             f"({modes}), expected {n_attn} attention layers x {n_rk} "
             f"ranks, {len(cross)} x {n_rk} non-causal")
    t0 = time.perf_counter()
    ref = lm.lm_prefill(params, cfg, batch)
    sync()
    wall_ref = time.perf_counter() - t0
    dp, sc = hold(f"{tag} prefill logits over the mesh vs unsharded", got,
                  ref, prefill_rtol)
    del got, ref
    print(f"[{tag}] {card}: {cfg.name} through build_step over "
          f"DeviceMesh.on(cuda:0, data={d}, model={m}), cache split by "
          f"block {split}: prefill {pb} x {plen} tokens in "
          f"{wall * 1e3:.1f} ms (unsharded {wall_ref * 1e3:.1f} ms), "
          f"{n7} flash_attention launches ({n_attn} attention layers x "
          f"{d} rows x {m} ranks, {n_nc} non-causal); logits max|d| "
          f"{dp:.3e} (limit {prefill_rtol:.4g}*{sc:.3f})")

    cache = shard_cache(cfg, ref_cache, mesh, split)
    if cross_states is not None:
        cache = lm.build_cross_cache(placed, cfg, cache, cross_states[:pb])
        ref_cache = lm.build_cross_cache(params, cfg, ref_cache,
                                         cross_states[:pb])
    ptrs, orig8, sharded_call, on_cross = set(), layers.flash_decode, \
        [False], [0]

    def spy8(q, kc, vc, *a, **kw):
        if sharded_call[0]:
            ptrs.update([kc.data_ptr(), vc.data_ptr()])
            on_cross[0] += bool(cross) and kc.shape[1] == cfg.n_cross_tokens
        return orig8(q, kc, vc, *a, **kw)

    pos = pos0.clone()
    worst, t_tp, t_ref, n8, n8c, held8 = 0.0, [], [], set(), set(), []
    layers.flash_decode = spy8
    try:
        for step in range(steps):
            fd.flash_decode.launches, on_cross[0] = 0, 0
            sharded_call[0] = True
            tok = toks[:, plen + step:plen + step + 1]
            t0 = time.perf_counter()
            with recording(layers, "flash_decode", held8, keep=lambda: (
                    (fd.flash_decode.launches - 1) // n_rk in watch)) \
                    if watch and step == steps - 1 \
                    else contextlib.nullcontext():
                got, cache = dec.fn(placed, cache, tok, pos)
            sync()
            t_tp.append(time.perf_counter() - t0)
            sharded_call[0] = False
            n8.add(fd.flash_decode.launches)
            n8c.add(on_cross[0])
            t0 = time.perf_counter()
            want, ref_cache = lm.lm_decode_step(params, cfg, ref_cache, tok,
                                                pos)
            sync()
            t_ref.append(time.perf_counter() - t0)
            dd, sc = hold(f"{tag} decode step {step} logits over the mesh",
                          got, want, decode_rtol)
            worst = max(worst, dd / sc)
            pos = pos + 1
    finally:
        layers.flash_decode = orig8
    own = cache_kv_ptrs(cache.shards)
    if n8 != {n_attn * n_rk} or n8c != {len(cross) * n_rk} \
            or not ptrs <= own:
        fail(f"{tag} mesh decode: flash_decode launches a step {n8} "
             f"(expected {n_attn * n_rk}), on the cross caches {n8c} "
             f"(expected {len(cross) * n_rk}), {len(ptrs - own)} cache "
             f"pointers not the rank caches'")
    n_on_cross = n8c.pop()
    p50, p50_ref = (float(np.percentile(t, 50)) * 1e3 for t in (t_tp, t_ref))
    print(f"[{tag}] {card}: {cfg.name} over ({d}, {m}): {steps} decode "
          f"steps of batch {pb} from position {plen} against a {plen}-row "
          f"prompt cache (max_len {max_len}), "
          f"{n_attn * n_rk} flash_decode launches a step"
          + (f" ({n_on_cross} counted on the ranks' cross caches)"
             if cross else "")
          + f", each on its rank's cache tensor; step p50 {p50:.2f} ms "
          f"(unsharded {p50_ref:.2f} ms; no gain is claimed: one card, "
          f"one thread issues every rank's work); logits max|d| "
          f"{worst:.3e} of max|ref| (limit {decode_rtol:.4g}); "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB")
    if len(held7) != len(watch) * n_rk or len(held8) != len(watch) * n_rk:
        fail(f"{tag}: kept {len(held7)} / {len(held8)} rank calls of #7 / "
             f"#8 at attention layers {watch}, not {n_rk} each")
    errs = {}
    for j in watch:
        what = f"{'cross' if j in cross else 'self-attention'} layer {j}"
        errs[j] = [max(e for e, _ in hold_captured(
            f"{tag} {name} on the ranks' slices of {what}",
            calls_at(held, j), plain)) for name, held, plain in (
            ("flash_attention", held7, fa.flash_attention_plain),
            ("flash_decode", held8, fd.flash_decode_plain))]
        (q, k, _), _, _ = calls_at(held7, j)[0]
        kc = calls_at(held8, j)[0][0][1]
        print(f"[{tag}] flash_attention / flash_decode on the {n_rk} ranks' "
              f"slices of {what} (q {tuple(q.shape)} over k "
              f"{tuple(k.shape)}; cache {tuple(kc.shape)} at step "
              f"{steps - 1}) vs plain: max|d| {errs[j][0]:.3e} / "
              f"{errs[j][1]:.3e}")
    if kernels is not None and cross:
        j = cross[0]
        (q, k, v), kw, _ = calls_at(held7, j)[0]
        name = f"{cfg.name} over ({d}, {m}), a rank's cross layer"
        opts = {n: x for n, x in kw.items() if x is not None and n != "scale"}
        kernels["flash_attention"].setdefault("shapes", {})[name] = dict(
            time_flash(q, k, v, opts, errs[j][0], name), launches=n_nc)
        call8 = calls_at(held8, j)[0]
        kc = call8[0][1]
        kernels["flash_decode"].setdefault("shapes", {})[name] = dict(
            max_abs_err=errs[j][1], launches=n_on_cross,
            **time_decode(call8, fd.default_splits(
                kc.shape[0], kc.shape[2], kc.shape[1]),
                f"{name}, step {steps - 1}"))
    del placed, cache, ref_cache, held7, held8
    torch.cuda.empty_cache()


def nudged_limits(tag, params, cfg, batch, toks, cache0, pos0, factor,
                  prefill_rtol, decode_rtol):
    """The model's own float32 conditioning: how far the unsharded
    prefill logits of ``batch`` and the logits of decode steps of
    ``toks`` (B, n) from ``cache0`` (copied, left as it is) at ``pos0``
    move when every weight moves by at most one ulp (a copy of
    ``params``, times 1 + k * 2**-23, k in {-1, 0, 1} from the seed). ->
    (max(prefill_rtol, factor x the prefill's move), max(decode_rtol,
    factor x the decode steps' largest move)), each a share of
    max|ref|."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models.params import map_tree

    dev = toks.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    nudged = map_tree(lambda t: t * (1 + 2.0 ** -23 * torch.randint(
        -1, 2, t.shape, generator=gen, device=dev).to(t.dtype)), params)

    def run(p):
        out = [lm.lm_prefill(p, cfg, batch)]
        cache, pos = map_tree(torch.clone, cache0), pos0
        for j in range(toks.shape[1]):
            logits, cache = lm.lm_decode_step(p, cfg, cache,
                                              toks[:, j:j + 1], pos)
            out.append(logits)
            pos = pos + 1
        return out

    moves = [d / sc for d, sc in (rel_err(a, b) for a, b in
                                  zip(run(nudged), run(params)))]
    del nudged
    torch.cuda.empty_cache()
    limits = (max(prefill_rtol, factor * moves[0]),
              max(decode_rtol, factor * max(moves[1:])))
    print(f"[{tag}] {cfg.name}: every weight moved by at most one ulp moves "
          f"the unsharded prefill logits by {moves[0]:.3e} and the decode "
          f"steps' by up to {max(moves[1:]):.3e} of max|ref|: the mesh's "
          f"limits are max(fixed, {factor:g} x that): prefill "
          f"{limits[0]:.4g}, decode {limits[1]:.4g}")
    return limits


def serve_through_decode(card, tag, params, cfg, reset_counts,
                         check_cfg=None, cross_states=None,
                         cache_dtype=None, attn_rtol=ATTN_RTOL,
                         gap_rtol=1e-3, reqs=None):
    """``DecodeEngine(batch, max_len, cache_dtype)`` of LM_SIZES (float32
    caches unless ``cache_dtype``) serving its greedy requests: one #8
    launch an attention layer and step, every request finished, #8 held
    against its plain version within ``attn_rtol`` on the first and the
    last attention layer's operands (and the first cross layer's) at step
    0, step 64 and a later step with a free slot at a stale position, two
    requests' first and last tokens cross-checked against the argmax of
    ``lm_prefill`` under ``check_cfg`` (default ``cfg``), a token allowed
    to differ only where the prefill's top-2 gap is within ``gap_rtol`` *
    max|logits|, and every #8 launch reading the engine's cache tensors
    themselves (their data pointers), not a copy; decode tokens/s, step
    and request latency. A cross-attention
    model's engine gets its cross cache from ``cross_states`` (row i slot
    i's image), and each checked request's prefill gets its slot's row. ->
    (#8 timed at the serving shape, #8 launches, the engine, the step
    latencies in s, #8 timed at the cross shape or None). ``reqs`` stands
    in for phase 7's requests where given."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import layers, lm
    from repro_torch.serving import DecodeEngine, Request

    dev, sizes = torch.device("cuda"), LM_SIZES
    n_attn, cross = attn_layers(cfg), cross_layers(cfg)
    ends = sorted({0, n_attn - 1, *cross[:1]})
    cfg_flash = dataclasses.replace(check_cfg or cfg, use_flash=True)

    def engine():
        eng = DecodeEngine(params, cfg, batch=sizes["serve_batch"],
                           max_len=sizes["serve_max_len"],
                           cache_dtype=cache_dtype or torch.float32,
                           device=dev)
        if cross_states is not None:
            eng.cache = lm.build_cross_cache(params, cfg, eng.cache,
                                             cross_states)
        return eng

    warm = engine()
    warm.submit(Request(rid=-1, prompt=[1, 2], max_new=2))
    warm.run()
    del warm
    eng = engine()
    reqs = reqs or serving_requests(cfg)
    # The slot each request is admitted into (its image, when there is
    # one).
    slot_of, admit = {}, eng._admit

    def admitting():
        admit()
        for i, r in enumerate(eng.slots):
            if r is not None:
                slot_of.setdefault(r.rid, i)

    eng._admit = admitting
    # The kept layers' #8 calls at the first step, step 64, and the first
    # later step with a free slot at a stale position (it decodes into the
    # void and still writes its cache row).
    held8, kept_steps, stale = [], [0, 64], []

    def keep8():
        layer = (fd.flash_decode.launches - 1) % n_attn
        if len(kept_steps) == 2 and layer == 0 and eng.steps > 64 and (
                ~eng.active & (eng.pos > 0)).any():
            kept_steps.append(eng.steps)
            stale.extend(np.flatnonzero(~eng.active).tolist())
        return layer in ends and eng.steps in kept_steps

    rows, stored = {}, {}
    own = cache_kv_ptrs(eng.cache)

    def storage(a, _):
        return "cache" if {a[1].data_ptr(), a[2].data_ptr()} <= own \
            else "copy"

    reset_counts()
    with tallied(layers, "flash_decode", lambda a, _: a[1].shape[1], rows), \
            tallied(layers, "flash_decode", storage, stored), \
            recording(layers, "flash_decode", held8, keep=keep8):
        step_s, finish_s, wall = serve_timed(eng, reqs)
    del eng._admit
    if stored != {"cache": eng.steps * n_attn}:
        fail(f"flash_decode launches by the cache they read: {stored}, "
             f"expected every one of {eng.steps * n_attn} on the engine's "
             f"cache tensors, none on a copy")
    n8 = fd.flash_decode.launches
    n8_cross = rows.get(cfg.n_cross_tokens, 0) if cross else 0
    if n8 != n_attn * eng.steps or n8_cross != len(cross) * eng.steps:
        fail(f"serving launched flash_decode {n8} times in {eng.steps} "
             f"steps (by cache rows {rows}), expected {n_attn} per step, "
             f"{len(cross)} of them over the cross cache")
    if len(kept_steps) != 3 or len(held8) != 3 * len(ends):
        fail(f"kept {len(held8)} decode calls of flash_decode at steps "
             f"{kept_steps}, not {3 * len(ends)} at 3 steps with a stale "
             f"slot among them")

    def splits(call):
        kc = call[0][1]
        return fd.default_splits(kc.shape[0], kc.shape[2], kc.shape[1])

    err8 = {False: 0.0, True: 0.0}
    for i, (d, sc) in enumerate(hold_captured(
            "flash_decode on the serving operands", held8,
            fd.flash_decode_plain, attn_rtol)):
        lens = held8[i][0][3].tolist()
        s_len = held8[i][0][1].shape[1]
        layer = ends[i % len(ends)]
        err8[layer in cross] = max(err8[layer in cross], d)
        at_stale = i >= 2 * len(ends)
        print(f"[{tag}] flash_decode at step {kept_steps[i // len(ends)]}, "
              f"{'cross' if layer in cross else 'attention'} layer {layer} "
              f"of {n_attn} ({s_len}-row cache, lengths {lens}, "
              f"{decode_splits(held8[i][0][1], lens, held8[i][1])}"
              f"{f', free slots {stale} at stale lengths' if at_stale else ''}"
              f") vs plain: max|d| {d:.3e} (limit {attn_rtol:.4g}*"
              f"{sc:.3f})")
    # Timed at the serving shape: the kept layers' calls of the last kept
    # step.
    last = held8[2 * len(ends):]
    timed8 = dict(max_abs_err=err8[False], **time_decode(
        last[0], splits(last[0]),
        f"serving step {kept_steps[2]} attention layer 0"))
    timed_cross = None if not cross else dict(
        max_abs_err=err8[True], launches=n8_cross, **time_decode(
            last[ends.index(cross[0])], splits(last[ends.index(cross[0])]),
            f"serving step {kept_steps[2]} cross layer {cross[0]} (every "
            f"image row visible)"))
    del held8, last
    gaps = []
    for r in reqs[:sizes["cross_checked"]]:
        for j in (0, r.max_new - 1):
            seq = torch.as_tensor([r.prompt + r.out[:j]], dtype=torch.int32,
                                  device=dev)
            batch = {"tokens": seq}
            if cross_states is not None:
                slot = slot_of[r.rid]
                batch["cross_states"] = cross_states[slot:slot + 1]
            lg = lm.lm_prefill(params, cfg_flash, batch)[0, 0]
            top = torch.topk(lg, 2).values
            gap = float(top[0] - top[1])
            tol = gap_rtol * float(lg.abs().max())
            pred = int(torch.argmax(lg))
            gaps.append((r.rid, j, pred == r.out[j], gap))
            if pred != r.out[j] and gap > tol:
                fail(f"request {r.rid} token {j}: decode gave {r.out[j]}, "
                     f"prefill argmax {pred} with top-2 gap {gap} > {tol}")
    print(f"[{tag}] {card}: "
          + serving_line(reqs, eng, step_s, finish_s, wall)
          + f"; {n8} flash_decode launches"
          + (f" ({n8_cross} over the cross cache)" if cross else "")
          + f", by the cache they read {stored}")
    print(f"[{tag}] decode vs prefill argmax (rid, j, equal, top-2 gap): "
          + ", ".join(f"({a}, {b}, {c}, {g:.4g})" for a, b, c, g in gaps))
    return timed8, n8, eng, np.asarray(step_s[:eng.steps]), timed_cross


def lm_phases(card, kernels, launches, reset_counts) -> None:
    """Phases 5-7: the LM kernels held against their plain versions, the
    Qwen3-1.7B prefill through #7, and ``DecodeEngine`` through #8, each
    kernel also held on the operands the main path gave it. Fills
    ``kernels`` and ``launches`` for #7 / #8."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import lm
    from repro_torch.models.params import param_bytes
    from repro_torch.serving import Request

    dev, sizes, sync = torch.device("cuda"), LM_SIZES, torch.cuda.synchronize
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # -- phase 5: #7 and #8 against their plain versions ---------------------
    for i, (name, b, sq, skv, hq, hkv, d, opts) in enumerate(sizes["flash"]):
        q, k, v = randn(b, sq, hq, d), randn(b, skv, hkv, d), \
            randn(b, skv, hkv, d)
        err, sc = hold(f"flash_attention at {name}",
                       fa.flash_attention(q, k, v, **opts),
                       fa.flash_attention_plain(q, k, v, scale=d ** -0.5,
                                                **opts), ATTN_RTOL)
        tiles = fa.tile_config(d)
        n_qt = -(-sq // tiles["block_q"])
        grid = f"({n_qt * b * hq},) = {n_qt} query tiles x {b * hq} rows"
        print(f"[lm-kernels] flash_attention at {name} (B={b} Sq={sq} "
              f"Skv={skv} Hq={hq} Hkv={hkv} D={d} {opts or 'causal'}; grid "
              f"{grid}, {tiles}): max|d| {err:.3e} (limit "
              f"{ATTN_RTOL}*{sc:.3f})")
        if i == 0:
            kernels["flash_attention"] = dict(
                route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:27",
                **time_flash(q, k, v, opts, err, name))
        elif i == 1:
            kernels["flash_attention"]["long_seq"] = {
                name: time_flash(q, k, v, opts, err, name)}
        del q, k, v
    long_cache = {}
    for i, (name, b, s, hq, hkv, d, opts) in enumerate(sizes["decode"]):
        q, kc, vc = randn(b, hq, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        lens_np = rng.integers(1, s + 1, size=b).astype(np.int32)
        lens = torch.as_tensor(lens_np, device=dev)
        plain = lambda: fd.flash_decode_plain(q, kc, vc, lens,
                                              scale=d ** -0.5, **opts)
        ref = plain()
        got = fd.flash_decode(q, kc, vc, lens, **opts)
        err, sc = hold(f"flash_decode at {name}", got, ref, ATTN_RTOL)
        per_seq = [len(r) for r in fd.split_ranges(
            lens_np.tolist(), s, fd.default_splits(b, hkv, s), hkv,
            opts.get("window"))]
        print(f"[lm-kernels] flash_decode at {name} (B={b} S={s} Hq={hq} "
              f"Hkv={hkv} D={d} {opts}, lengths {lens_np.tolist()}, splits "
              f"{per_seq}): max|d| {err:.3e} (limit {ATTN_RTOL}*{sc:.3f})")
        if i == 0:
            n_def = fd.default_splits(b, hkv, s)
            other = fd.flash_decode(q, kc, vc, lens, num_splits=64, **opts)
            ds, _ = hold("flash_decode at the default split vs 64 splits",
                         other, got, SPLIT_RTOL)
            print(f"[lm-kernels] flash_decode at the default split (at most "
                  f"{n_def} a sequence) vs num_splits=64: max|d| {ds:.3e} "
                  f"(limit {SPLIT_RTOL}*{sc:.3f})")
            visible = int(np.minimum(lens_np, s).sum())
            qt = q[:, :, None]
            kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
            mask = (torch.arange(s, device=dev)[None, :]
                    < lens[:, None])[:, None, None, :]
            lib = sdpa_yardstick(qt, kt, vt, attn_mask=mask)
            # The long-cache shape; the serving shape (phase 7) is the
            # one the kernel's line reports.
            long_cache[name] = dict(
                max_abs_err=err,
                ms=cuda_time_ms(lambda: fd.flash_decode(q, kc, vc, lens,
                                                        **opts), 20),
                plain_ms=cuda_time_ms(plain, 5),
                library_ms=cuda_time_ms(lib, 20),
                ops=dict(fp32=4 * visible * hq * d),
                bytes=4 * (2 * visible * hkv * d + 2 * q.numel()) + 4 * b,
                shape=f"{name} B={b} S={s} Hq={hq} Hkv={hkv} D={d}, "
                      f"{visible} visible keys, at most {n_def} splits a "
                      f"sequence")
            del kt, vt, lib, mask
        del q, kc, vc, ref, got
    torch.cuda.empty_cache()

    # -- phase 6: Qwen3-1.7B prefill through #7 ------------------------------
    cfg = configs.get_config(sizes["arch"], smoke=sizes["smoke"])
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, SEED, device=dev)
    sync()
    print(f"[lm-prefill] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.head_dim}, vocab {cfg.vocab}: "
          f"{param_bytes(params) / 1e9:.2f} GB of float32 params built in "
          f"{time.perf_counter() - t0:.2f} s")
    prng = np.random.default_rng(SEED + 6)
    toks = torch.as_tensor(prng.integers(
        0, cfg.vocab, size=(sizes["prefill_batch"], sizes["prefill_len"]))
        .astype(np.int32), device=dev)
    launches["flash_attention"], held7, _, _ = prefill_through_flash(
        card, "lm-prefill", params, cfg, toks, reset_counts)
    del held7
    profile_lm(f"prefill call of {toks.shape[0]} x {toks.shape[1]} tokens",
               lambda: lm.lm_prefill(params, dataclasses.replace(
                   cfg, use_flash=True), {"tokens": toks}), 1,
               card, "flash_kernel")

    # -- phase 7: DecodeEngine through #8 ------------------------------------
    timed8, launches["flash_decode"], eng, _, _ = serve_through_decode(
        card, "lm-serve", params, cfg, reset_counts)
    kernels["flash_decode"] = dict(
        route="cuda", source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:28", **timed8,
        long_cache=long_cache)
    steps = 4
    eng.submit(Request(rid=10**6, prompt=[1] * (steps + 1), max_new=1))
    eng.step()                                   # admit, warm
    profile_lm(f"decode steps of batch {eng.batch}", eng.step, steps, card,
               "decode_")
    del params, eng


def profile_lm(what: str, fn, n: int, card: str, kernel: str) -> None:
    """``n`` calls of ``fn`` under ``torch.profiler``: wall and device busy
    time per call, the device's idle share, the share of the busy time in
    the device activities whose name holds ``kernel``, the top device
    activities and the top host operators by self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, by_name = device_busy(prof.events())
    if busy_us <= 0:
        fail(f"the profiler recorded no device activity in a {what}")
    mine = sum(sum(d) for name, d in by_name.items() if kernel in name)
    print(f"[lm-profile] {card}: {n} {what}: wall {wall_us / n / 1e3:.2f} ms "
          f"per call, device busy {busy_us / n / 1e3:.2f} ms (idle "
          f"{100 * (1 - busy_us / wall_us):.1f} %), of which {kernel}* "
          f"{mine / n / 1e3:.3f} ms ({100 * mine / busy_us:.1f} %)")
    calls = {e.key: e.count for e in prof.key_averages()
             if e.key.startswith(("cudaLaunch", "cudaMemcpy"))}
    print(f"[profile] host runtime calls in the step: " + ", ".join(
        f"{k} {v}" for k, v in sorted(calls.items())))
    for name, d in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]:
        print(f"  device {sum(d) / n / 1e3:8.3f} ms/call "
              f"x{len(d) // n:<5d} {name[:80]}")
    for e in sorted(prof.key_averages(),
                    key=lambda e: e.self_cpu_time_total, reverse=True)[:8]:
        print(f"  host   {e.self_cpu_time_total / n / 1e3:8.3f} ms/call "
              f"x{e.count // n:<5d} {e.key[:80]}")


def tf32_line() -> str:
    import torch
    return (f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
            f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
            f" cudnn.benchmark={torch.backends.cudnn.benchmark}"
            f" cudnn.deterministic={torch.backends.cudnn.deterministic}")


def profile_train(what: str, fn, card: str) -> None:
    """One training step under ``torch.profiler``: wall, device busy time
    and idle share, and the top device activities by time. Only the CUDA
    activity is traced (it records the runtime calls too): a step of tens
    of thousands of launches then takes seconds, not a minute, to read,
    and the wall time carries no host-operator profiling."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    busy_us, by_name = device_busy(events)
    if busy_us <= 0:
        fail(f"the profiler recorded no device activity in a {what}")
    print(f"[train-profile] {card}: one {what}: wall {wall_us / 1e3:.2f} ms, "
          f"device busy {busy_us / 1e3:.2f} ms (idle "
          f"{100 * (1 - busy_us / wall_us):.1f} %, busy share "
          f"{100 * busy_us / wall_us:.1f} %)")
    calls: dict = {}
    for e in events:
        if e.name.startswith(("cudaLaunch", "cudaMemcpy")):
            calls[e.name] = calls.get(e.name, 0) + 1
    print("[train-profile] host runtime calls in the step: " + ", ".join(
        f"{k} {v}" for k, v in sorted(calls.items())))
    for name, d in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]:
        print(f"  device {sum(d) / 1e3:8.3f} ms x{len(d):<5d} "
              f"{100 * sum(d) / busy_us:5.1f} % {name[:80]}")
    print(f"[train-profile] the profile took "
          f"{time.perf_counter() - t_prof:.1f} s to take and read")


def no_kernel_launched(what: str, wrappers: dict) -> None:
    launched = {n: fn.launches for n, fn in wrappers.items() if fn.launches}
    if launched:
        fail(f"{what} launched hand-written kernels {launched}; training "
             f"has no kernel with a backward")


def dcn_train_phase(card: str, wrappers: dict) -> None:
    """Phase 8: DCN training at the paper's ImageNet size, fused against
    unfused, then the example configuration to convergence."""
    import numpy as np
    import torch

    from repro_torch import checkpoint
    from repro_torch._tree import (flatten_with_names, tree_leaves,
                                   tree_map, tree_unflatten, value_and_grad)
    from repro_torch.configs import get_dcn_config
    from repro_torch.data import DataConfig, image_batch
    from repro_torch.launch.train import (dcn_loss, dcn_train_loop,
                                          dcn_train_step)
    from repro_torch.models.dcn_models import (DcnNetConfig, dcn_net_apply,
                                               init_dcn_net)
    from repro_torch.optim import AdamWConfig, init_opt_state

    dev, sync, sz = torch.device("cuda"), torch.cuda.synchronize, TRAIN_SIZES
    print(f"[dcn-train] settings in force: {tf32_line()}")
    cfg = get_dcn_config("vgg19", 3)
    params0 = init_dcn_net(SEED, cfg, device=dev)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=300,
                       weight_decay=0.01)
    dcfg = DataConfig(seed=SEED, global_batch=sz["dcn_batch"])
    batches = []
    for s in range(sz["dcn_steps"]):
        b = image_batch(dcfg, s, img=cfg.img_size, classes=cfg.num_classes)
        batches.append((torch.as_tensor(b["images"], device=dev),
                        torch.as_tensor(b["labels"], device=dev)))
    x0, y0 = batches[0]

    for w in wrappers.values():
        w.launches = 0

    def grads(fused):
        return value_and_grad(
            lambda p: dcn_loss(p, cfg, x0, y0, fused=fused), params0)

    def worst_gap(ga, gb):
        return max(float((a - b).norm()) / max(float(b.norm()), 1e-30)
                   for a, b in zip(tree_leaves(ga), tree_leaves(gb)))

    # The noise floor: by default the gathers' backward adds with
    # atomics, so even two unfused runs differ; the first conv's weight
    # gradient, a sum over 16 x 224 x 224 positions that largely cancels,
    # shows it most.
    (_, gu1), (_, gu2), (_, gf1) = grads(False), grads(False), grads(True)
    sync()
    print(f"[dcn-train] {card}: default (atomic) backward: worst norm-wise "
          f"gap over the gradient tensors: unfused vs unfused "
          f"{worst_gap(gu1, gu2):.3e}, fused vs unfused "
          f"{worst_gap(gf1, gu1):.3e}")
    del gu1, gu2, gf1
    # Step 0: loss and gradients, fused against unfused, each backward
    # with its deterministic kernels, so only the fusion can differ.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (lf, gf), (lu, gu) = grads(True), grads(False)
        sync()
    finally:
        torch.use_deterministic_algorithms(False)
    if not (torch.isfinite(lf) and abs(float(lf) - float(lu))
            <= GRAD_RTOL * abs(float(lu))):
        fail(f"step-0 loss fused {float(lf)} vs unfused {float(lu)}")
    worst = 0.0
    for (name, g), w in zip(flatten_with_names(gf), tree_leaves(gu)):
        ref = float(w.norm())
        d = float((g - w).norm())
        if not (torch.isfinite(g).all() and d <= GRAD_RTOL * ref):
            fail(f"step-0 gradient {name}: |fused - unfused| {d} > "
                 f"{GRAD_RTOL} * {ref}")
        worst = max(worst, d / ref if ref else 0.0)
    n_leaves = len(tree_leaves(gu))
    exact = all(torch.equal(a, b) for a, b in zip(tree_leaves(gf),
                                                  tree_leaves(gu)))
    print(f"[dcn-train] {card}: {cfg.name}-{cfg.n_deform} {cfg.variant} "
          f"{cfg.img_size}x{cfg.img_size}, {cfg.num_classes} classes, batch "
          f"{sz['dcn_batch']}, deterministic backward: step-0 loss fused "
          f"{float(lf):.6f} unfused {float(lu):.6f}; {n_leaves} gradient "
          f"tensors, worst norm-wise |fused - unfused| / |unfused| "
          f"{worst:.3e} (limit {GRAD_RTOL}), bitwise equal: {exact}")
    zero_grad = [n for (n, g) in flatten_with_names(gu) if not g.abs().max()]
    del gf, gu

    # What the forward keeps for the backward: the memory a loss holds
    # until its backward runs.
    held = {}
    for fused in (True, False):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params0)]
        sync()
        before = torch.cuda.memory_allocated()
        loss = dcn_loss(tree_unflatten(params0, leaves), cfg, x0, y0,
                        fused=fused)
        sync()
        held[fused] = torch.cuda.memory_allocated() - before
        del loss, leaves
    print(f"[dcn-train] {card}: memory the forward keeps for the backward: "
          f"fused {held[True] / 2**30:.3f} GiB, unfused "
          f"{held[False] / 2**30:.3f} GiB")

    results = {}
    for fused in (True, False):
        params = tree_map(torch.clone, params0)
        opt = init_opt_state(params, ocfg)
        first = tree_map(torch.clone, params)
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times, losses = [], []
        for x, y in batches:
            sync()
            t0 = time.perf_counter()
            params, opt, loss = dcn_train_step(params, opt, x, y, cfg, ocfg,
                                               fused=fused)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(v) for v in losses):
            fail(f"dcn training losses {losses} (fused={fused})")
        stuck = [n for (n, a), b in zip(flatten_with_names(first),
                                        tree_leaves(params))
                 if n not in zero_grad and torch.equal(a, b)]
        if stuck:
            fail(f"parameters with a gradient did not move: {stuck}")
        p50 = float(np.percentile(times, 50))
        results[fused] = (p50, peak, base)
        print(f"[dcn-train] {card}: fused={fused}: {len(times)} AdamW steps, "
              f"losses {[round(v, 4) for v in losses]}, step p50 "
              f"{p50 * 1e3:.2f} ms (all {[round(t * 1e3, 2) for t in times]})"
              f" = {sz['dcn_batch'] / p50:.1f} images/s; peak allocated "
              f"{peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above "
              f"the {base / 2**30:.3f} GiB held before the steps)")
        if fused:
            profile_train(f"fused DCN training step of {sz['dcn_batch']} "
                          f"images", lambda: dcn_train_step(
                              params, opt, x0, y0, cfg, ocfg), card)
        del params, opt, first
    (pf, mf, bf), (pu, mu, bu) = results[True], results[False]
    print(f"[dcn-train] {card}: fused / unfused step p50 {pf / pu:.3f}, peak "
          f"above the held tensors {(mf - bf) / 2**30:.3f} / "
          f"{(mu - bu) / 2**30:.3f} GiB")
    no_kernel_launched("DCN training", wrappers)

    # The grad guard: the kernel backends and #1's wrapper refuse to
    # differentiate, and launch nothing.
    for backend in ("graph", "pallas"):
        try:
            value_and_grad(lambda p: dcn_net_apply(
                p, cfg, x0[:1], backend=backend).sum(), params0)
        except ValueError as e:
            if "forward-only" not in str(e):
                raise
        else:
            fail(f"backend={backend!r} returned a result under autograd")
    from repro_torch.kernels.dcn_fused import dcn_fused_batch
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)
    w_req = torch.zeros((1, 16, 4), device=dev, requires_grad=True)
    try:
        dcn_fused_batch(torch.zeros((2, 4, 16), device=dev), i32(0, 1),
                        i32([0], [1]), i32(1, 1),
                        torch.zeros((2, 2, 1, 4), dtype=torch.int32,
                                    device=dev),
                        torch.zeros((2, 2, 1, 4), device=dev), w_req,
                        torch.zeros(4, device=dev), t_in=2)
    except ValueError as e:
        if "requires grad" not in str(e):
            raise
        print(f"[dcn-train] grad guard: backend='graph' and 'pallas' refuse "
              f"a gradient; dcn_fused_batch on the card refuses: {e}")
    else:
        fail("dcn_fused_batch took an operand that requires grad")
    no_kernel_launched("the grad-guard check", wrappers)
    del params0, batches, x0, y0
    torch.cuda.empty_cache()

    # The example configuration, to convergence.
    ex = DcnNetConfig("vgg19", 3, "dcn2", img_size=32, width_mult=0.25,
                      num_classes=4)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        params, opt, losses = dcn_train_loop(
            ex, steps=sz["example_steps"], batch=16, lr=3e-4, ckpt_dir=d,
            ckpt_every=100, verbose=False, device=dev)
        wall = time.perf_counter() - t0
        steps = checkpoint.completed_steps(d)
        back = checkpoint.restore(d, steps[-1], {"params": params,
                                                 "opt": opt}, device=dev)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(back), tree_leaves({"params": params, "opt": opt})))
    tail = float(np.mean(losses[-sz["example_tail"]:]))
    print(f"[dcn-train] {card}: example config (32x32, width 0.25, 4 "
          f"classes, batch 16): {len(losses)} steps in {wall:.2f} s "
          f"({len(losses) / wall:.1f} steps/s with data made on the host), "
          f"loss {losses[0]:.4f} -> {losses[-1]:.6f}, mean of the last "
          f"{sz['example_tail']} {tail:.6f} (limit {sz['example_limit']}); "
          f"checkpoints at {steps}, the last equal to the trained state: "
          f"{same}")
    if not all(math.isfinite(v) for v in losses) or \
            not tail < sz["example_limit"]:
        fail(f"the example did not train: last-{sz['example_tail']} mean "
             f"{tail}")
    if steps != list(range(100, sz["example_steps"] + 1, 100)) or not same:
        fail(f"example checkpoints {steps}, last equal to the state: {same}")


def lm_train_phase(card: str, wrappers: dict) -> None:
    """Phase 9: Qwen3-1.7B training steps at full width, then the resume
    check on its smoke config."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data import DataConfig, token_batch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models import lm
    from repro_torch.models.params import param_bytes
    from repro_torch.optim import AdamWConfig, init_opt_state

    dev, sync, sz = torch.device("cuda"), torch.cuda.synchronize, TRAIN_SIZES
    torch.cuda.empty_cache()
    cfg = configs.get_config(sz["lm_arch"])
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = lm.init_lm(cfg, SEED, device=dev)
    ocfg = AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=sz["lm_steps"])
    opt = init_opt_state(params, ocfg)
    pb = param_bytes(params)
    print(f"[lm-train] {card}: {cfg.name} {cfg.n_layers} layers, float32 "
          f"params {pb / 1e9:.2f} GB and AdamW m + v {2 * pb / 1e9:.2f} GB; "
          f"with the gradients p + g + m + v = {4 * pb / 1e9:.2f} GB before "
          f"activations; remat={cfg.remat!r}; {tf32_line()}")
    step = build_train_step(cfg, ocfg)
    dcfg = DataConfig(seed=SEED, vocab=cfg.vocab, seq=sz["lm_seq"],
                      global_batch=sz["lm_batch"])
    for w in wrappers.values():
        w.launches = 0
    times, losses = [], []
    for s in range(sz["lm_steps"]):
        batch = token_batch(dcfg, s)
        sync()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    no_kernel_launched("LM training", wrappers)
    if not all(math.isfinite(v) for v in losses):
        fail(f"LM training losses {losses}")
    toks = sz["lm_batch"] * sz["lm_seq"]
    warm = times[1:] or times
    print(f"[lm-train] {card}: {len(times)} steps of {sz['lm_batch']} x "
          f"{sz['lm_seq']} tokens: losses {[round(v, 4) for v in losses]}, "
          f"step times {[round(t * 1e3, 1) for t in times]} ms; after the "
          f"first, mean {np.mean(warm) * 1e3:.1f} ms = "
          f"{toks / np.mean(warm):.0f} training tokens/s; peak allocated "
          f"{(peak - base) / 1e9:.2f} GB ({(peak - base) / pb:.2f} x the "
          f"params)")
    profile_train(f"Qwen3-1.7B training step of {toks} tokens",
                  lambda: step(params, opt, token_batch(dcfg, 0)), card)
    # The other remat policies on the same state: two steps each, the
    # second timed, with its peak.
    for remat in ("none", "full", "dots"):
        rstep = build_train_step(dc.replace(cfg, remat=remat), ocfg)
        for s in range(2):
            batch = token_batch(dcfg, sz["lm_steps"] + s)
            sync()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, opt, m = rstep(params, opt, batch)
            loss = float(m["loss"])
            dt = time.perf_counter() - t0
        if not math.isfinite(loss):
            fail(f"LM training loss {loss} with remat={remat!r}")
        print(f"[lm-train] {card}: remat={remat!r}: step {dt * 1e3:.1f} ms "
              f"= {toks / dt:.0f} training tokens/s, peak allocated "
              f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB")
    no_kernel_launched("LM training", wrappers)
    del params, opt, step, rstep
    torch.cuda.empty_cache()

    # Resume: a run restarted from its step-2 checkpoint gives the
    # unbroken run's step-3 loss.
    small = configs.get_config(sz["lm_arch"], smoke=True)
    shape = configs.ShapeCell("resume", "train", 64, 4)
    kw = dict(opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3),
              ckpt_every=2, verbose=False, device=dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, _, whole = train_loop(small, shape, steps=3, **kw)
        with tempfile.TemporaryDirectory() as d:
            train_loop(small, shape, steps=2, ckpt_dir=d, **kw)
            _, _, rest = train_loop(small, shape, steps=3, ckpt_dir=d, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"[lm-train] {card}: {small.name}: unbroken losses {whole}; "
          f"resumed from the step-2 checkpoint: step-3 loss {rest}")
    if rest != whole[2:]:
        fail(f"resumed step-3 loss {rest} != unbroken {whole[2:]}")


def moe_phases(card, kernels, wrappers, reset_counts, peak_bw) -> None:
    """Phase 10: granite-moe-3b-a800m ``full()`` served through #7 / #8
    (10a), and deepseek-v3-671b at full width with its depth cut (10b),
    whose MLA path runs no hand-written kernel. Adds the granite shapes to
    #7's and #8's ``shapes``."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm, moe, transformer
    from repro_torch.models.params import param_bytes, param_count
    from repro_torch.serving import DecodeEngine, Request

    dev, sync, sz = torch.device("cuda"), torch.cuda.synchronize, MOE_SIZES

    def counted(cfg, want):
        n = param_count(lm.init_lm(cfg, device="meta"))
        if n != want:
            fail(f"{cfg.name}: param_count {n:,} on meta, expected {want:,}")
        return n

    def peak(part):
        print(f"[lm-moe] {part}: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # -- 10a: granite-moe-3b-a800m full() through #7 and #8 ------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(sz["granite"])
    n = counted(cfg, sz["granite_params"])
    params = lm.init_lm(cfg, SEED, device=dev)
    m = cfg.moe
    print(f"[lm-moe] {cfg.name} full(): {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.head_dim}, {m.n_experts} experts padded to "
          f"{m.n_experts_padded} (ep {m.ep}), top-{m.top_k}, expert d_ff "
          f"{m.d_ff}, vocab {cfg.vocab} tied, logits_scale "
          f"{cfg.logits_scale}: param_count {n:,} = "
          f"{param_bytes(params) / 1e9:.2f} GB of float32 params from seed "
          f"{SEED}")
    prng = np.random.default_rng(SEED + 6)
    toks = torch.as_tensor(prng.integers(
        0, cfg.vocab, size=(LM_SIZES["prefill_batch"],
                            LM_SIZES["prefill_len"])).astype(np.int32),
        device=dev)
    n7, held7, _, _ = prefill_through_flash(card, "lm-moe", params, cfg, toks,
                                         reset_counts)
    (q, k, v, *_), kw, _ = held7[0]
    del held7
    opts = {o: kw[o] for o in ("window", "softcap") if kw.get(o) is not None}
    name = f"{cfg.name} prefill"
    err, sc = hold(f"flash_attention at {name}",
                   fa.flash_attention(q, k, v, **opts),
                   fa.flash_attention_plain(q, k, v, scale=q.shape[-1] ** -0.5,
                                            **opts), ATTN_RTOL)
    print(f"[lm-moe] flash_attention at {name} (layer 0's operands, q "
          f"{tuple(q.shape)}, k {tuple(k.shape)}) vs plain: max|d| "
          f"{err:.3e} (limit {ATTN_RTOL}*{sc:.3f})")
    kernels["flash_attention"].setdefault("shapes", {})[name] = dict(
        time_flash(q, k, v, opts, err, name), launches=n7)
    del q, k, v
    peak("10a prefill")
    profile_lm(f"{cfg.name} prefill call of {toks.shape[0]} x "
               f"{toks.shape[1]} tokens", lambda: lm.lm_prefill(
                   params, dataclasses.replace(cfg, use_flash=True),
                   {"tokens": toks}), 1, card, "flash_kernel")

    timed8, n8, eng, step_s, _ = serve_through_decode(
        card, "lm-moe", params, cfg, reset_counts,
        reqs=short_requests(cfg))
    kernels["flash_decode"].setdefault("shapes", {})[
        f"{cfg.name} decode"] = dict(timed8, launches=n8)
    # One more step, profiled, after one that keeps layer 0's MoE input.
    held_moe = []
    eng.submit(Request(rid=10**6, prompt=[1, 2], max_new=1))
    with recording(transformer, "moe_apply", held_moe,
                   keep=lambda: not held_moe):
        eng.step()
    profile_lm(f"{cfg.name} decode step of batch {eng.batch}", eng.step, 1,
               card, "decode_")
    (p_l, mcfg, h), _, _ = held_moe[0]
    t = h.shape[0] * h.shape[1]
    cap = moe.capacity(mcfg, t)
    e, d, f = mcfg.n_experts_padded, mcfg.d_model, mcfg.d_ff
    slots = torch.randn(e, cap, d, device=dev)
    t_moe = cuda_time_ms(lambda: moe.moe_apply(p_l, mcfg, h), 20)
    t_ffn = cuda_time_ms(lambda: moe._expert_ffn(
        slots, p_l["w_gate"], p_l["w_up"], p_l["w_down"]), 20)
    w_bytes = 3 * e * d * f * 4
    bound = w_bytes / peak_bw * 1e3
    print(f"[lm-moe] {card}: one MoE layer at decode (T={t}, cap {cap}, "
          f"{e} x {cap} slots), CUDA events: moe_apply {t_moe:.4f} ms, of "
          f"which the expert einsums (_expert_ffn) {t_ffn:.4f} ms "
          f"({100 * t_ffn / t_moe:.1f} %) and routing + dispatch + combine "
          f"{t_moe - t_ffn:.4f} ms ({100 * (1 - t_ffn / t_moe):.1f} %); "
          f"every expert's weights are read: {w_bytes / 1e6:.1f} MB a layer "
          f"(bound {bound:.4f} ms at {peak_bw / 1e12:g} TB/s), "
          f"{cfg.n_layers * w_bytes / 1e9:.2f} GB a step (bound "
          f"{cfg.n_layers * bound:.3f} ms); {cfg.n_layers} layers x "
          f"moe_apply = {cfg.n_layers * t_moe:.2f} ms a step; the served "
          f"step's p50 {np.percentile(step_s, 50) * 1e3:.2f} ms")
    peak("10a decode")
    del params, eng, held_moe, p_l, h, slots
    torch.cuda.empty_cache()

    # -- 10b: deepseek-v3-671b at full width, depth cut ----------------------
    torch.cuda.reset_peak_memory_stats()
    full = configs.get_config(sz["deepseek"])
    n_full = counted(full, sz["deepseek_params"])
    cfg = dataclasses.replace(full, prefix=full.prefix[:1], n_repeats=1)
    n = counted(cfg, sz["deepseek_cut_params"])
    params = lm.init_lm(cfg, SEED, device=dev)
    m = cfg.moe
    print(f"[lm-moe] {full.name}: full() has {full.n_layers} layers and "
          f"{n_full:,} params ({4 * n_full / 1e12:.2f} TB in float32); cut "
          f"to prefix[:1] + n_repeats=1 for the card's 80 GB: one dense MLA "
          f"layer (d_ff {cfg.d_ff}) and one MLA + MoE layer ({m.n_experts} "
          f"routed + {m.n_shared} shared experts of d_ff {m.d_ff}, top-"
          f"{m.top_k} {m.router}, routed_scale {m.routed_scale}) plus the "
          f"MTP block: {n:,} params = {param_bytes(params) / 1e9:.2f} GB "
          f"float32; every width published (d_model {cfg.d_model}, "
          f"{cfg.mla.n_heads} heads, q_lora {cfg.mla.q_lora_rank}, kv_lora "
          f"{cfg.mla.kv_lora_rank}, vocab {cfg.vocab})")
    reset_counts()
    prng = np.random.default_rng(SEED + 10)
    pb, plen = sz["ds_prefill"]
    toks = torch.as_tensor(prng.integers(0, cfg.vocab, size=(pb, plen))
                           .astype(np.int32), device=dev)
    lm.lm_prefill(params, cfg, {"tokens": toks[:, :64]})         # warm-up
    sync()
    t0 = time.perf_counter()
    logits = lm.lm_prefill(params, cfg, {"tokens": toks})
    sync()
    wall = time.perf_counter() - t0
    if tuple(logits.shape) != (pb, 1, cfg.vocab) or \
            not torch.isfinite(logits).all():
        fail(f"deepseek prefill logits {tuple(logits.shape)} not finite")
    print(f"[lm-moe] {card}: {full.name} (cut) prefill {pb} x {plen} tokens "
          f"in {wall * 1e3:.1f} ms = {pb * plen / wall:.0f} prefill "
          f"tokens/s; logits finite")
    peak("10b prefill")
    # Absorbed MLA decode (a float32 latent cache) against the train path;
    # with the capacity lifted, the check holds MLA alone.
    decode_vs_prefill("lm-moe", params, cfg, toks[:, :sz["ds_check_len"]])
    eng = DecodeEngine(params, cfg, batch=sz["ds_requests"],
                       max_len=sz["ds_max_len"], device=dev)
    lo, hi = sz["ds_prompt_len"]
    reqs = [Request(rid=rid, max_new=sz["ds_max_new"], prompt=prng.integers(
        0, cfg.vocab, size=int(prng.integers(lo, hi + 1))).tolist())
        for rid in range(sz["ds_requests"])]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run()
    sync()
    wall = time.perf_counter() - t0
    bad = [r.rid for r in reqs if not r.done or len(r.out) != r.max_new]
    if bad:
        fail(f"deepseek requests {bad} did not finish with max_new tokens")
    n_tok = sum(len(r.out) for r in reqs)
    print(f"[lm-moe] {card}: {full.name} (cut) DecodeEngine(batch "
          f"{eng.batch}): {len(reqs)} requests (prompts "
          f"{[len(r.prompt) for r in reqs]}) in {eng.steps} steps, {n_tok} "
          f"new tokens in {wall:.2f} s = {n_tok / wall:.2f} decode tokens/s "
          f"({1e3 * wall / eng.steps:.1f} ms a step)")
    counts = {name: w.launches for name, w in wrappers.items()}
    if any(counts.values()):
        fail(f"the MLA path launched hand-written kernels {counts}")
    print(f"[lm-moe] no kernel wrapper launched on the MLA path: {counts}")
    peak("10b decode")
    del eng, logits
    # 10c: the same weights over the mesh, MLA split by heads.
    mesh_split_run(card, "lm-moe", params, cfg, "deepseek")
    del params
    torch.cuda.empty_cache()


def no_drops(cfg):
    """``cfg`` with a MoE's capacity lifted to T slots an expert, so that a
    prefill drops no (token, expert) pair, as decode at T = B never does:
    both then compute one function."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts_padded / cfg.moe.top_k))


def decode_vs_prefill(tag, params, cfg, toks, cross_states=None,
                      cache_dtype=None, rtol=LOGIT_RTOL):
    """The prompts ``toks`` (B, n) fed token by token through
    ``lm_decode_step`` (float32 caches unless ``cache_dtype``) give
    ``lm_prefill``'s last-position logits within ``rtol``: each block's
    decode form (a recurrence, the absorbed MLA, #8 over the cross cache
    ``build_cross_cache`` made of ``cross_states``) against its train form
    (chunked scans, MLA, attention over the states), under
    ``no_drops``."""
    import torch

    from repro_torch.models import lm, moe

    b, n = toks.shape
    chk = no_drops(cfg)
    if cfg.moe is not None and moe.capacity(chk.moe, b * n) < b * n:
        fail("the decode-vs-prefill prefill could drop routed pairs")
    cache = lm.init_cache(chk, b, n, dtype=cache_dtype or torch.float32,
                          device="cuda")
    batch = {"tokens": toks}
    if cross_states is not None:
        cache = lm.build_cross_cache(params, chk, cache, cross_states)
        batch["cross_states"] = cross_states
    t0 = time.perf_counter()
    for i in range(n):
        got, cache = lm.lm_decode_step(
            params, chk, cache, toks[:, i:i + 1],
            torch.full((b,), i, dtype=torch.int32, device=toks.device))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d, sc = hold(f"{cfg.name}: decode vs prefill logits", got,
                 lm.lm_prefill(params, chk, batch), rtol)
    print(f"[{tag}] {cfg.name}: {b} prompts of {n} tokens one by one "
          f"through lm_decode_step ({1e3 * wall / n:.1f} ms a step) vs "
          f"lm_prefill (the train path)"
          + ("" if chk is cfg else f", capacity_factor "
             f"{chk.moe.capacity_factor:g}")
          + f": last-position logits max|d| {d:.3e} (limit "
          f"{rtol:.4g}*{sc:.3f})")


def slot_reuse(tag, eng, first):
    """``first``, served again by ``eng`` after its run (so into a slot
    other requests have used), gets the greedy tokens it got in the fresh
    engine: the admission reset the slot's recurrent state."""
    from repro_torch.serving import Request

    again = Request(rid=10**6 + 1, prompt=list(first.prompt),
                    max_new=first.max_new)
    used = sorted({r.rid for r in eng.finished})
    eng.submit(again)
    eng.run()
    if not again.done or again.out != first.out:
        fail(f"{eng.cfg.name}: request {first.rid} in a used slot gave "
             f"{again.out}, in a fresh one {first.out}")
    print(f"[{tag}] {eng.cfg.name}: request {first.rid} served again in "
          f"slot 0 after requests {used} used the engine's {eng.batch} "
          f"slots: the same {len(first.out)} greedy tokens as in the fresh "
          f"engine")


@contextlib.contextmanager
def event_timed(module, name, store: list):
    """Each call of ``module.name`` in the block bracketed by CUDA events;
    ``store`` gets the (start, end) pairs."""
    import torch

    orig = getattr(module, name)

    def shim(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = orig(*a, **k)
        ev[1].record()
        store.append(ev)
        return out

    setattr(module, name, shim)
    try:
        yield
    finally:
        setattr(module, name, orig)


def recurrent_phases(card, kernels, wrappers, reset_counts, peak_bw) -> None:
    """Phase 11: jamba-v0.1-52b at full width with its depth cut to one
    period, served through #7 / #8 (11a), and xlstm-1.3b ``full()`` whole,
    whose mLSTM / sLSTM path runs no hand-written kernel (11b). Adds
    jamba's shapes to #7's and #8's ``shapes``."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm, xlstm
    from repro_torch.models.params import param_bytes, param_count
    from repro_torch.serving import DecodeEngine, Request

    dev, sync, sz = torch.device("cuda"), torch.cuda.synchronize, REC_SIZES
    pb, plen = sz["prefill"]

    def counted(cfg, want):
        n = param_count(lm.init_lm(cfg, device="meta"))
        if n != want:
            fail(f"{cfg.name}: param_count {n:,} on meta, expected {want:,}")
        return n

    def peak(part):
        print(f"[lm-recurrent] {part}: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    def tokens(cfg, seed, *shape):
        rng = np.random.default_rng(seed)
        return torch.as_tensor(rng.integers(0, cfg.vocab, size=shape)
                               .astype(np.int32), device=dev)

    def engine(params, cfg):
        return DecodeEngine(params, cfg, batch=LM_SIZES["serve_batch"],
                            max_len=LM_SIZES["serve_max_len"], device=dev)

    # -- 11a: jamba-v0.1-52b, one period at full width, through #7 and #8 ----
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"[lm-recurrent] memory_allocated before phase 11 "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    full = configs.get_config(sz["jamba"])
    n_full = counted(full, sz["jamba_params"])
    cfg = dataclasses.replace(full, n_repeats=1)
    n = counted(cfg, sz["jamba_cut_params"])
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, SEED, device=dev)
    sync()
    m, mb = cfg.moe, cfg.mamba
    print(f"[lm-recurrent] {full.name}: full() has {full.n_layers} layers "
          f"and {n_full:,} params ({4 * n_full / 1e9:.1f} GB in float32); "
          f"cut to n_repeats=1 for the card's 80 GB: one period of "
          f"{cfg.n_layers} layers ({sum(s.kind == 'mamba' for s in cfg.pattern)}"
          f" Mamba, {attn_layers(cfg)} attention; "
          f"{sum(s.mlp == 'moe' for s in cfg.pattern)} MoE, "
          f"{sum(s.mlp == 'dense' for s in cfg.pattern)} dense MLPs), "
          f"{n:,} params = {param_bytes(params) / 1e9:.2f} GB float32 from "
          f"seed {SEED} in {time.perf_counter() - t0:.1f} s; every width "
          f"published (d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads}"
          f" heads x {cfg.head_dim}, d_ff {cfg.d_ff}, {m.n_experts} experts "
          f"top-{m.top_k}, Mamba d_inner {mb.d_inner} d_state {mb.d_state} "
          f"dt_rank {mb.rank} chunk {mb.chunk_size}, vocab {cfg.vocab})")
    toks = tokens(cfg, SEED + 11, pb, plen)
    n7, held7, wall, _ = prefill_through_flash(card, "lm-recurrent", params,
                                            cfg, toks, reset_counts)
    (q, k, v, *_), kw, _ = held7[0]
    del held7
    name = f"{cfg.name} prefill"
    err, sc = hold(f"flash_attention at {name}", fa.flash_attention(q, k, v),
                   fa.flash_attention_plain(q, k, v,
                                            scale=q.shape[-1] ** -0.5),
                   ATTN_RTOL)
    print(f"[lm-recurrent] flash_attention at {name} (the attention "
          f"layer's operands, q {tuple(q.shape)}, k {tuple(k.shape)}, group "
          f"{q.shape[2] // k.shape[2]}) vs plain: max|d| {err:.3e} (limit "
          f"{ATTN_RTOL}*{sc:.3f})")
    kernels["flash_attention"].setdefault("shapes", {})[name] = dict(
        time_flash(q, k, v, {}, err, name), launches=n7)
    del q, k, v
    peak("11a prefill")
    profile_lm(f"{cfg.name} prefill call of {pb} x {plen} tokens",
               lambda: lm.lm_prefill(params, dataclasses.replace(
                   cfg, use_flash=True), {"tokens": toks}), 1, card,
               "flash_kernel")
    del toks
    torch.cuda.empty_cache()

    timed8, n8, eng, step_s, _ = serve_through_decode(
        card, "lm-recurrent", params, cfg, reset_counts,
        check_cfg=no_drops(cfg))
    kernels["flash_decode"].setdefault("shapes", {})[
        f"{cfg.name} decode"] = dict(timed8, launches=n8)
    w_bytes = param_bytes(params) - params["embed"].numel() * 4
    print(f"[lm-recurrent] {card}: a {cfg.name} (cut) decode step reads "
          f"every weight but the embedding table, all {m.n_experts} experts "
          f"of the MoE layers included: {w_bytes / 1e9:.2f} GB, bound "
          f"{w_bytes / peak_bw * 1e3:.2f} ms at {peak_bw / 1e12:g} TB/s; "
          f"served step p50 {np.percentile(step_s, 50) * 1e3:.2f} ms")
    slot_reuse("lm-recurrent", eng,
               next(r for r in eng.finished if r.rid == 0))
    eng.submit(Request(rid=10**6, prompt=[1, 2, 3], max_new=1))
    eng.step()                                   # admit, warm
    profile_lm(f"{cfg.name} decode steps of batch {eng.batch}", eng.step,
               2, card, "decode_")
    del eng
    peak("11a decode")
    decode_vs_prefill("lm-recurrent", params, cfg, tokens(
        cfg, SEED + 12, sz["check_batch"], sz["check_len"]["jamba"]))
    peak("11a decode vs prefill")
    # 11c: the same weights over the mesh, Mamba split by channel.
    mesh_split_run(card, "lm-recurrent", params, cfg, "jamba")
    del params
    torch.cuda.empty_cache()

    # -- 11b: xlstm-1.3b full(), whole; no hand-written kernel ---------------
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(sz["xlstm"])
    n = counted(cfg, sz["xlstm_params"])
    params = lm.init_lm(cfg, SEED, device=dev)
    x = cfg.xlstm_cfg
    print(f"[lm-recurrent] {cfg.name} full(), whole: {cfg.n_layers} blocks "
          f"({sum(s.kind == 'mlstm' for s in cfg.pattern) * cfg.n_repeats} "
          f"mLSTM, {sum(s.kind == 'slstm' for s in cfg.pattern) * cfg.n_repeats}"
          f" sLSTM), d_model {cfg.d_model}, {x.n_heads} heads, mLSTM d_inner "
          f"{x.d_inner} (head {x.d_head}) chunk {x.chunk_size}, vocab "
          f"{cfg.vocab} tied: {n:,} params = {param_bytes(params) / 1e9:.2f}"
          f" GB float32 from seed {SEED}")
    reset_counts()
    toks = tokens(cfg, SEED + 13, pb, plen)
    lm.lm_prefill(params, cfg, {"tokens": toks[:, :64]})          # warm-up
    sync()
    spans = {"mlstm_train": [], "slstm_train": []}
    with event_timed(xlstm, "mlstm_train", spans["mlstm_train"]), \
            event_timed(xlstm, "slstm_train", spans["slstm_train"]):
        t0 = time.perf_counter()
        logits = lm.lm_prefill(params, cfg, {"tokens": toks})
        sync()
        wall = time.perf_counter() - t0
    if tuple(logits.shape) != (pb, 1, cfg.vocab) or \
            not torch.isfinite(logits).all():
        fail(f"xlstm prefill logits {tuple(logits.shape)} not finite")
    share = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3
             for k, v in spans.items()}
    print(f"[lm-recurrent] {card}: {cfg.name} prefill {pb} x {plen} tokens "
          f"in {wall * 1e3:.1f} ms = {pb * plen / wall:.0f} prefill "
          f"tokens/s; logits finite; by CUDA events the "
          f"{len(spans['slstm_train'])} sLSTM layers (a time loop of "
          f"{plen} cell steps each) {share['slstm_train'] * 1e3:.1f} ms "
          f"({100 * share['slstm_train'] / wall:.1f} %), the "
          f"{len(spans['mlstm_train'])} mLSTM layers "
          f"{share['mlstm_train'] * 1e3:.1f} ms "
          f"({100 * share['mlstm_train'] / wall:.1f} %)")
    del logits, toks
    peak("11b prefill")
    warm = engine(params, cfg)
    warm.submit(Request(rid=-1, prompt=[1, 2], max_new=2))
    warm.run()
    del warm
    eng = engine(params, cfg)
    reqs = short_requests(cfg)
    step_s, finish_s, wall = serve_timed(eng, reqs)
    print(f"[lm-recurrent] {card}: {cfg.name}: "
          + serving_line(reqs, eng, step_s, finish_s, wall))
    slot_reuse("lm-recurrent", eng, reqs[0])
    eng.submit(Request(rid=10**6, prompt=[1, 2, 3], max_new=1))
    eng.step()                                   # admit, warm
    profile_lm(f"{cfg.name} decode steps of batch {eng.batch}", eng.step,
               2, card, "elementwise")
    del eng
    peak("11b decode")
    decode_vs_prefill("lm-recurrent", params, cfg, tokens(
        cfg, SEED + 14, sz["check_batch"], sz["check_len"]["xlstm"]))
    counts = {name: w.launches for name, w in wrappers.items()}
    if any(counts.values()):
        fail(f"the xLSTM path launched hand-written kernels {counts}")
    print(f"[lm-recurrent] no kernel wrapper launched on the xLSTM path: "
          f"{counts}")
    peak("11b decode vs prefill")
    # 11d: the same weights over the mesh, mLSTM / sLSTM split by head.
    mesh_split_run(card, "lm-recurrent", params, cfg, "xlstm")
    counts = {name: w.launches for name, w in wrappers.items()}
    if any(counts.values()):
        fail(f"the xLSTM path over the mesh launched hand-written kernels "
             f"{counts}")
    del params
    torch.cuda.empty_cache()


def cross_phase(card, kernels, reset_counts, peak_bw) -> None:
    """Phase 12: llama-3.2-vision-11b ``full()``, whole, with random
    float32 image states: prefill through #7 (non-causal in the 8 cross
    layers), serving through #8 with the cross cache ``build_cross_cache``
    filled (the cross layers over all 1,601 image rows), decode vs
    prefill over the same states, and the logits' dependence on the
    image. Adds the cross shapes to #7's and #8's ``shapes``."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.models.params import param_bytes, param_count
    from repro_torch.serving import Request

    dev, sync, sz = torch.device("cuda"), torch.cuda.synchronize, CROSS_SIZES
    pb, plen = sz["prefill"]

    def peak(part):
        print(f"[lm-cross] {part}: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"[lm-cross] memory_allocated before phase 12 "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    cfg = configs.get_config(sz["llama"])
    n = param_count(lm.init_lm(cfg, device="meta"))
    if n != sz["llama_params"]:
        fail(f"{cfg.name}: param_count {n:,} on meta, expected "
             f"{sz['llama_params']:,}")
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, SEED, device=dev)
    sync()
    n_attn, cross = attn_layers(cfg), cross_layers(cfg)
    print(f"[lm-cross] {cfg.name} full(), whole: {cfg.n_layers} layers, "
          f"cross-attention at layers {cross} over {cfg.n_cross_tokens} "
          f"image tokens of width {cfg.d_cross} (the vision tower is a "
          f"stub: random float32 states from seed {SEED + 12}); d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab} untied: "
          f"param_count {n:,} = {param_bytes(params) / 1e9:.2f} GB float32 "
          f"from seed {SEED} in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)

    def image_states(b):
        return torch.randn((b, cfg.n_cross_tokens, cfg.d_cross),
                           generator=gen, device=dev)

    def tokens(seed, *shape):
        rng = np.random.default_rng(seed)
        return torch.as_tensor(rng.integers(0, cfg.vocab, size=shape)
                               .astype(np.int32), device=dev)

    states = image_states(pb)
    toks = tokens(SEED + 12, pb, plen)
    n7, held7, wall, n_nc = prefill_through_flash(
        card, "lm-cross", params, cfg, toks, reset_counts,
        cross_states=states)
    at = sorted({0, n_attn - 1, cross[0], cross[-1]}).index(cross[0])
    (q, k, v, *_), kw, _ = held7[at]
    del held7
    name = f"{cfg.name} cross-layer prefill"
    err, sc = hold(f"flash_attention at {name}",
                   fa.flash_attention(q, k, v, causal=False),
                   fa.flash_attention_plain(q, k, v, causal=False,
                                            scale=q.shape[-1] ** -0.5),
                   ATTN_RTOL)
    print(f"[lm-cross] flash_attention at {name} (cross layer {cross[0]}'s "
          f"operands, {kw}, q {tuple(q.shape)} over k {tuple(k.shape)}, "
          f"group {q.shape[2] // k.shape[2]}) vs plain: max|d| {err:.3e} "
          f"(limit {ATTN_RTOL}*{sc:.3f})")
    kernels["flash_attention"].setdefault("shapes", {})[name] = dict(
        time_flash(q, k, v, {"causal": False}, err, name), launches=n_nc)
    del q, k, v
    peak("12 prefill")
    profile_lm(f"{cfg.name} prefill call of {pb} x {plen} tokens",
               lambda: lm.lm_prefill(params, dataclasses.replace(
                   cfg, use_flash=True), {"tokens": toks,
                                          "cross_states": states}), 1,
               card, "flash_kernel")
    del toks
    torch.cuda.empty_cache()

    timed8, n8, eng, step_s, timed_cross = serve_through_decode(
        card, "lm-cross", params, cfg, reset_counts, cross_states=states)
    shapes8 = kernels["flash_decode"].setdefault("shapes", {})
    shapes8[f"{cfg.name} decode, self layers"] = dict(
        timed8, launches=n8 - timed_cross["launches"])
    shapes8[f"{cfg.name} decode, cross layers"] = timed_cross
    cross_bytes = sum(t.numel() * t.element_size()
                      for j, spec in enumerate(cfg.pattern) if spec.cross
                      for t in eng.cache["stack"][f"b{j}"]["mix"].values())
    w_bytes = param_bytes(params) - params["embed"].numel() * 4
    print(f"[lm-cross] {card}: a {cfg.name} decode step reads every weight "
          f"but the embedding table ({w_bytes / 1e9:.2f} GB) and the cross "
          f"K/V ({cross_bytes / 1e9:.3f} GB): "
          f"{(w_bytes + cross_bytes) / 1e9:.2f} GB, bound "
          f"{(w_bytes + cross_bytes) / peak_bw * 1e3:.2f} ms at "
          f"{peak_bw / 1e12:g} TB/s; served step p50 "
          f"{np.percentile(step_s, 50) * 1e3:.2f} ms")
    eng.submit(Request(rid=10**6, prompt=[1, 2, 3], max_new=1))
    eng.step()                                   # admit, warm
    profile_lm(f"{cfg.name} decode steps of batch {eng.batch}", eng.step,
               2, card, "decode_")
    del eng
    peak("12 decode")

    cb, clen = sz["check"]
    chk, cs = tokens(SEED + 13, cb, clen), states[:cb]
    decode_vs_prefill("lm-cross", params, cfg, chk, cross_states=cs)
    peak("12 decode vs prefill")
    cfg_flash = dataclasses.replace(cfg, use_flash=True)
    a = lm.lm_prefill(params, cfg_flash, {"tokens": chk, "cross_states": cs})
    b = lm.lm_prefill(params, cfg_flash, {"tokens": chk,
                                          "cross_states": image_states(cb)})
    d, sc = rel_err(b, a)
    if not (torch.isfinite(b).all() and d > LOGIT_RTOL * sc):
        fail(f"{cfg.name}: another image moved the logits by {d}, not more "
             f"than {LOGIT_RTOL}*{sc}")
    print(f"[lm-cross] {cfg.name}: the same {cb} x {clen} prompts under "
          f"another image: last-position logits move by max|d| {d:.3e} "
          f"(> {LOGIT_RTOL}*{sc:.3f}): the cross layers read the image")
    del a, b
    # 12b: the same weights over the mesh, the cross layers split by head.
    mesh_split_run(card, "lm-cross", params, cfg, "llama", kernels=kernels,
                   cross_states=states)
    del params, states
    torch.cuda.empty_cache()


def half_name(dtype) -> str:
    """A 16-bit type's short name, "bf16" or "fp16" (also the key of its
    dense tensor-core rate)."""
    return "fp16" if str(dtype) == "torch.float16" else "bf16"


def time_flash_16(q, k, v, opts, err, name) -> dict:
    """#7's 16-bit kernel on bf16 or float16 (q, k, v) timed beside the
    float32 kernel on the same values widened, the plain version and the
    SDPA yardstick in the same type; the work and bytes of its bound
    (operations at the dense 16-bit tensor-core rate)."""
    from repro_torch.kernels import flash_attention as fa

    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    causal = opts.get("causal", True)
    tiles = fa.tile_config(d, q.dtype)
    n_qt = -(-sq // tiles["block_q"])
    grid = f"({n_qt * b * hq},) = {n_qt} query tiles x {b * hq} rows"
    qf, kf, vf = q.float(), k.float(), v.float()
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = sdpa_yardstick(qt, kt, vt, is_causal=causal)
    live = live_pairs(sq, skv, causal, opts.get("window"))
    out = dict(
        max_abs_err=err,
        ms=cuda_time_ms(lambda: fa.flash_attention(q, k, v, **opts), 10),
        f32_kernel_ms=cuda_time_ms(
            lambda: fa.flash_attention(qf, kf, vf, **opts), 10),
        plain_ms=cuda_time_ms(lambda: fa.flash_attention_plain(
            q, k, v, scale=d ** -0.5, **opts), 2, warmup=1),
        library_ms=cuda_time_ms(lib, 5),
        ops={half_name(q.dtype): 4 * b * hq * live * d},
        bytes=2 * (2 * q.numel() + k.numel() + v.numel()),
        shape=f"{half_name(q.dtype)} {name} B={b} S={sq}"
              f"{'' if skv == sq else f' Skv={skv}'} Hq={hq} Hkv={hkv} "
              f"D={d}, {'causal' if causal else 'non-causal'} (live share "
              f"{live / (sq * skv):.4f}), grid {grid}, {tiles['block_q']} x "
              f"{tiles['block_k']} tiles, {tiles['smem_bytes']} B shared, "
              f"{tiles['swizzle']} B swizzle, {tiles['stages']}-tile K / V "
              f"rings")
    del qf, kf, vf, qt, kt, vt
    return out


def time_decode_16(q, kc, vc, lens, opts, err, name) -> dict:
    """#8 over a bf16 or float16 cache (q float32 or of the cache's type)
    timed beside the same kernel over the cache widened to float32, the
    plain version and the SDPA yardstick in the cache's type; the bytes of
    its bound (the visible keys of both caches at 2 bytes a value, q and
    the output in q's type)."""
    import torch

    from repro_torch.kernels import flash_decode as fd

    b, s, hkv, d = kc.shape
    kw = {k: v for k, v in opts.items() if k != "num_splits"}
    w = kw.get("window")
    vis = sum(max(0, min(n, s) - (max(0, n - w) if w else 0))
              for n in lens.tolist())
    ki = torch.arange(s, device=kc.device)[None, :]
    mask = ki < lens[:, None].long()
    if kw.get("window") is not None:
        mask &= ki > lens[:, None].long() - 1 - kw["window"]
    kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
    lib = sdpa_yardstick(q.to(kc.dtype)[:, :, None], kt, vt,
                         attn_mask=mask[:, None, None, :],
                         scale=d ** -0.5)
    kf, vf = kc.float(), vc.float()
    out = dict(
        max_abs_err=err,
        ms=cuda_time_ms(lambda: fd.flash_decode(q, kc, vc, lens, **opts),
                        100),
        f32_cache_ms=cuda_time_ms(
            lambda: fd.flash_decode(q, kf, vf, lens, **opts), 100),
        plain_ms=cuda_time_ms(lambda: fd.flash_decode_plain(
            q, kc, vc, lens, scale=d ** -0.5, **kw), 20),
        library_ms=cuda_time_ms(lib, 100),
        ops=dict(fp32=4 * vis * q.shape[1] * d),
        bytes=2 * 2 * vis * hkv * d + 2 * q.numel() * q.element_size()
        + 4 * b,
        shape=f"{half_name(kc.dtype)} cache, "
              f"{str(q.dtype).removeprefix('torch.')} q, "
              f"{name}, B={b} S={s} Hq={q.shape[1]} Hkv={hkv} D={d} "
              f"{kw or ''}, lengths {lens.tolist()[:8]}"
              f"{'...' if b > 8 else ''}, {vis} visible keys, "
              f"{decode_splits(kc, lens.tolist(), opts)}")
    del kt, vt, kf, vf
    return out


def half_kernels(kernels, dtype, decode=None) -> None:
    """Phase 13a (bf16) / 18a (float16): #7's 16-bit kernel and #8 over
    caches of ``dtype`` held against their plain versions on the card, at
    the serving path's shapes (``BF16_SIZES``; ``decode`` names the #8
    shapes to run, default all), rerun bitwise, and timed. Adds the
    ``bf16`` / ``fp16`` entries of #7 and #8 (float16 ones named with a
    leading "fp16 ")."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    dev, sz = torch.device("cuda"), BF16_SIZES
    short, long_name = half_name(dtype), str(dtype).removeprefix("torch.")
    rtol = BF16_RTOL if dtype == torch.bfloat16 else F16_RTOL
    tag = "lm-bf16" if dtype == torch.bfloat16 else "lm-fp16"
    pre = "" if dtype == torch.bfloat16 else "fp16 "
    seed = SEED + (13 if dtype == torch.bfloat16 else 18)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)

    def randn(*shape, dtype=dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    entries7 = kernels["flash_attention"].setdefault(short, {})
    for name, b, sq, skv, hq, hkv, d, opts in sz["flash"]:
        q, k, v = randn(b, sq, hq, d), randn(b, skv, hkv, d), \
            randn(b, skv, hkv, d)
        fa.flash_attention.dtypes, fa.flash_attention.bodies = {}, {}
        got = fa.flash_attention(q, k, v, **opts)
        if got.dtype != dtype or fa.flash_attention.dtypes != {
                long_name: 1} or fa.flash_attention.bodies != {"16bit": 1}:
            fail(f"flash_attention at {short} {name}: {got.dtype} output, "
                 f"launches {fa.flash_attention.dtypes} "
                 f"{fa.flash_attention.bodies}")
        err, sc = hold(f"{short} flash_attention at {name}", got.float(),
                       fa.flash_attention_plain(q, k, v, scale=d ** -0.5,
                                                **opts).float(), rtol)
        if not torch.equal(fa.flash_attention(q, k, v, **opts), got):
            fail(f"{short} flash_attention at {name}: a rerun differs")
        print(f"[{tag}] flash_attention {short} at {name} (B={b} Sq={sq} "
              f"Skv={skv} Hq={hq} Hkv={hkv} D={d} {opts or 'causal'}; "
              f"{fa.tile_config(d, dtype)}): max|d| {err:.3e} "
              f"(limit {rtol:.4g}*{sc:.3f}), rerun bitwise equal")
        del got
        entries7[pre + name] = time_flash_16(q, k, v, opts, err, name)
        del q, k, v
        torch.cuda.empty_cache()

    entries8 = kernels["flash_decode"].setdefault(short, {})
    for name, b, s, hq, hkv, d, opts, lengths in sz["decode"]:
        if decode is not None and name not in decode:
            continue
        kc, vc = randn(b, s, hkv, d), randn(b, s, hkv, d)
        lens = torch.as_tensor(
            np.full(b, s) if lengths == "full" else
            rng.integers(1, s + 1, size=b), dtype=torch.int32, device=dev)
        kw = {k: v for k, v in opts.items() if k != "num_splits"}
        body = "cluster" if dtype == torch.bfloat16 else "split"
        for q_dtype, q_rtol in ((torch.float32, 1e-4), (dtype, rtol)):
            q = randn(b, hq, d, dtype=q_dtype)
            fd.flash_decode.dtypes, fd.flash_decode.bodies = {}, {}
            got = fd.flash_decode(q, kc, vc, lens, **opts)
            key = f"{str(q_dtype).removeprefix('torch.')}/{long_name}"
            if got.dtype != q_dtype or fd.flash_decode.dtypes != {key: 1} \
                    or fd.flash_decode.bodies != {body: 1}:
                fail(f"flash_decode over a {short} cache at {name}: "
                     f"{got.dtype} output, launches {fd.flash_decode.dtypes}"
                     f" {fd.flash_decode.bodies}")
            err, sc = hold(f"flash_decode over a {short} cache at {name}, "
                           f"{q_dtype} q", got.float(),
                           fd.flash_decode_plain(q, kc, vc, lens,
                                                 scale=d ** -0.5,
                                                 **kw).float(), q_rtol)
            if not torch.equal(fd.flash_decode(q, kc, vc, lens, **opts),
                               got):
                fail(f"flash_decode over a {short} cache at {name}: a "
                     f"rerun differs")
            print(f"[{tag}] flash_decode over a {short} cache at {name} "
                  f"({q_dtype} q, B={b} S={s} Hq={hq} Hkv={hkv} D={d} "
                  f"{opts}, {body} body): max|d| {err:.3e} (limit "
                  f"{q_rtol:.4g}*{sc:.3f}), rerun bitwise equal")
            entries8[f"{pre}{name}, "
                     f"{str(q_dtype).removeprefix('torch.')} q"] = \
                time_decode_16(q, kc, vc, lens, opts, err, name)
            del q, got
        del kc, vc
        torch.cuda.empty_cache()


def bf16_phase(card, kernels, reset_counts, peak_bw) -> None:
    """Phase 13: bf16 serving. 13a: ``half_kernels`` in bf16. 13b:
    llama-3.2-vision-11b ``full()``, whole, with bf16 params from the seed
    and random bf16 image states: a float32 run of the same bf16 weights
    sets the model's own bf16 rounding error (its noise floor); prefill
    through #7's bf16 kernel against the bf16 ``_sdpa`` path (40 launches,
    8 non-causal, all on bf16 operands), a ``cache_dtype=bfloat16``
    ``DecodeEngine`` serving ``short_requests`` through #8 over the bf16
    caches themselves (no copy: data pointers checked), decode vs prefill
    over the image, the image's effect, profiles and peak memory. The
    limits are ``BF16_LIMITS`` (written in PERF.md before the first run)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import lm
    from repro_torch.models.params import param_bytes, param_count
    from repro_torch.serving import Request

    dev, sync, sz = torch.device("cuda"), torch.cuda.synchronize, CROSS_SIZES
    pb, plen = sz["prefill"]
    lim = BF16_LIMITS

    def peak(part):
        print(f"[lm-bf16] {part}: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    torch.cuda.empty_cache()
    print(f"[lm-bf16] memory_allocated before phase 13 "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    half_kernels(kernels, torch.bfloat16)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(sz["llama"])
    cfg_flash = dataclasses.replace(cfg, use_flash=True)
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, SEED, device=dev, dtype=torch.bfloat16)
    sync()
    n = param_count(params)
    leaf_types = {t.dtype for t in tree_leaves(params)}
    if n != sz["llama_params"] or leaf_types != {torch.bfloat16}:
        fail(f"{cfg.name}: {n:,} params of {leaf_types}, expected "
             f"{sz['llama_params']:,} bf16")
    n_attn, cross = attn_layers(cfg), cross_layers(cfg)
    print(f"[lm-bf16] {cfg.name} full(), whole, in bf16: {n:,} params = "
          f"{param_bytes(params) / 1e9:.2f} GB bf16 from seed {SEED} in "
          f"{time.perf_counter() - t0:.1f} s; random bf16 image states "
          f"({pb}, {cfg.n_cross_tokens}, {cfg.d_cross}) from seed "
          f"{SEED + 14}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)

    def image_states(b):
        return torch.randn((b, cfg.n_cross_tokens, cfg.d_cross),
                           generator=gen, device=dev).to(torch.bfloat16)

    def tokens(seed, *shape):
        r = np.random.default_rng(seed)
        return torch.as_tensor(r.integers(0, cfg.vocab, size=shape)
                               .astype(np.int32), device=dev)

    states = image_states(pb)
    toks = tokens(SEED + 14, pb, plen)
    cb, clen = sz["check"]
    chk, cs = tokens(SEED + 15, cb, clen), states[:cb]
    other = image_states(cb)

    # The float32 run of the same bf16 weights and states (#7's float32
    # kernel): the exact function up to float32 rounding, against which
    # the bf16 paths' own rounding error is read.
    t0 = time.perf_counter()
    p32 = tree_map(lambda t: t.float(), params)
    ref32 = lm.lm_prefill(p32, cfg_flash, {"tokens": toks,
                                           "cross_states": states.float()})
    ref32_chk = lm.lm_prefill(p32, cfg_flash, {"tokens": chk,
                                               "cross_states": cs.float()})
    ref32_other = lm.lm_prefill(p32, cfg_flash, {
        "tokens": chk, "cross_states": other.float()})
    sync()
    peak("13 float32 reference (bf16 + float32 weights)")
    del p32
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"[lm-bf16] float32 run of the same weights ({pb} x {plen} and "
          f"the {cb} x {clen} check prompts under two images) in "
          f"{time.perf_counter() - t0:.1f} s")

    def floor(tag, got, ref):
        """The model's own bf16 error: max|got - ref| / max|ref|."""
        e = float((got.float() - ref).abs().max() / ref.abs().max())
        print(f"[lm-bf16] {tag} vs the float32 run: {e:.4e} of "
              f"max|ref|")
        return e

    def prefill_limit(sdpa16):
        eps = floor("bf16 _sdpa path prefill", sdpa16, ref32)
        rt = max(lim["noise_factor"] * eps, BF16_RTOL)
        print(f"[lm-bf16] prefill limit: max({lim['noise_factor']} x "
              f"{eps:.4e}, 2^-7) = {rt:.4e} of max|ref|")
        limits["prefill"] = rt
        return rt

    limits = {}
    fa.flash_attention.dtypes = {}
    n7, held7, wall, n_nc = prefill_through_flash(
        card, "lm-bf16", params, cfg, toks, reset_counts,
        cross_states=states, logit_rtol=prefill_limit, attn_rtol=BF16_RTOL)
    if fa.flash_attention.dtypes != {"bfloat16": n7} or n7 != n_attn:
        fail(f"the bf16 prefill launched flash_attention "
             f"{fa.flash_attention.dtypes}, expected {n_attn} on bf16 "
             f"operands")
    if any(a[0].dtype != torch.bfloat16 for a, _, _ in held7):
        fail("a prefill #7 call had float32 operands")
    print(f"[lm-bf16] {card}: bf16 prefill {pb} x {plen}: {n7} #7 "
          f"launches ({n_nc} non-causal), by operand type "
          f"{fa.flash_attention.dtypes}; {wall * 1e3:.1f} ms = "
          f"{pb * plen / wall:.0f} prefill tokens/s")
    del held7
    entries7 = kernels["flash_attention"]["bf16"]
    entries7["llama-3.2-vision self layer"]["launches"] = n7 - n_nc
    entries7["llama-3.2-vision cross layer"]["launches"] = n_nc
    flash16 = lm.lm_prefill(params, cfg_flash, {"tokens": toks,
                                                "cross_states": states})
    floor("bf16 flash path prefill", flash16, ref32)
    del flash16, ref32
    peak("13 prefill")
    profile_lm(f"{cfg.name} bf16 prefill call of {pb} x {plen} tokens",
               lambda: lm.lm_prefill(params, cfg_flash, {
                   "tokens": toks, "cross_states": states}), 1,
               card, "flash_kernel")
    del toks
    torch.cuda.empty_cache()

    fd.flash_decode.dtypes = {}
    timed8, n8, eng, step_s, timed_cross = serve_through_decode(
        card, "lm-bf16", params, cfg, reset_counts, cross_states=states,
        cache_dtype=torch.bfloat16, attn_rtol=BF16_RTOL,
        gap_rtol=limits["prefill"], reqs=short_requests(cfg))
    # The serving run's launches and the timing calls after it, by type.
    if set(fd.flash_decode.dtypes) != {"bfloat16/bfloat16"}:
        fail(f"bf16 serving launched flash_decode {fd.flash_decode.dtypes},"
             f" expected every launch on a bf16 q over a bf16 cache")
    shapes8 = kernels["flash_decode"].setdefault("bf16", {})
    shapes8[f"{cfg.name} bf16 decode, self layers"] = dict(
        timed8, launches=n8 - timed_cross["launches"])
    shapes8[f"{cfg.name} bf16 decode, cross layers"] = timed_cross
    cross_bytes = sum(t.numel() * t.element_size()
                      for j, spec in enumerate(cfg.pattern) if spec.cross
                      for t in eng.cache["stack"][f"b{j}"]["mix"].values())
    w_bytes = param_bytes(params) - params["embed"].numel() * 2
    print(f"[lm-bf16] {card}: a bf16 {cfg.name} decode step reads every "
          f"weight but the embedding table ({w_bytes / 1e9:.2f} GB) and "
          f"the cross K/V ({cross_bytes / 1e9:.3f} GB): "
          f"{(w_bytes + cross_bytes) / 1e9:.2f} GB, bound "
          f"{(w_bytes + cross_bytes) / peak_bw * 1e3:.2f} ms at "
          f"{peak_bw / 1e12:g} TB/s; served step p50 "
          f"{np.percentile(step_s, 50) * 1e3:.2f} ms; {n8} #8 launches "
          f"by type {fd.flash_decode.dtypes}")
    eng.submit(Request(rid=10**6, prompt=[1, 2, 3], max_new=1))
    eng.step()                                   # admit, warm
    profile_lm(f"{cfg.name} bf16 decode steps of batch {eng.batch}",
               eng.step, 2, card, "decode_")
    del eng
    peak("13 decode")

    flash_chk = lm.lm_prefill(params, cfg_flash, {"tokens": chk,
                                                  "cross_states": cs})
    eps = floor(f"bf16 flash path prefill of the {cb} x {clen} prompts",
                flash_chk, ref32_chk)
    rt = max(lim["noise_factor"] * eps, BF16_RTOL)
    decode_vs_prefill("lm-bf16", params, cfg_flash, chk, cross_states=cs,
                      cache_dtype=torch.bfloat16, rtol=rt)
    peak("13 decode vs prefill")
    moved = lm.lm_prefill(params, cfg_flash, {"tokens": chk,
                                              "cross_states": other})
    d, sc = rel_err(moved.float(), flash_chk.float())
    d32, sc32 = rel_err(ref32_other, ref32_chk)
    if not (torch.isfinite(moved.float()).all()
            and d > lim["image"] * sc):
        fail(f"{cfg.name} bf16: another image moved the logits by {d}, not "
             f"more than {lim['image']}*{sc}")
    print(f"[lm-bf16] {cfg.name} bf16: the same {cb} x {clen} prompts under "
          f"another image: last-position logits move by max|d| {d:.3e} = "
          f"{d / sc:.4f} of max|logits| (> {lim['image']:.4g}); the float32 "
          f"run of the same weights moves by {d32 / sc32:.4f}")
    del params, states, flash_chk, moved, ref32_chk, ref32_other
    torch.cuda.empty_cache()


def half_dcn_kernels(kernels, ops, contraction, fused_ops, dtype) -> None:
    """Phase 14a (bf16) / 18a (float16): #1, #4 and #5 on x, w and b of
    ``dtype`` (float32 coefficients) at phase 2's full-width VGG19-3
    shapes (``ops``: a list of (name, shape tag, wrapper, plain version,
    float32 args, kwargs, positions of x / w / b, rows of the
    contraction, live output pixels)): each held against its plain
    version (BF16_RTOL / F16_RTOL * max|ref|), rerun bitwise, one launch
    of ``dtype`` a call; timed beside the float32 kernel on the same
    values widened, the plain version and ``torch.matmul`` of the
    float32 contraction (in float16 too, for float16); a mixed call (x of
    ``dtype`` under float32 w and b) runs the float32 kernel and rounds
    once. bf16 calls run the Hopper body (each call's grid and cluster
    size printed), float16 ones the split-C body (its grid and split).
    Adds the ``bf16`` / ``fp16`` entries of the three kernels (float16
    ones named with a leading "fp16 "); the bytes of their bounds at 2 B
    a value, the operations at the 3xbf16 (bf16) / 2xTF32 (float16: the
    weight is exact in TF32) rate."""
    import torch

    from repro_torch.kernels import dcn_fused as kf

    short, long_name = half_name(dtype), str(dtype).removeprefix("torch.")
    bf16 = dtype == torch.bfloat16
    rtol = BF16_RTOL if bf16 else F16_RTOL
    tag = "dcn-bf16" if bf16 else "dcn-fp16"
    for name, shape_tag, fn, plain, args, kw, at, rows, live in ops:
        a16 = [t.to(dtype) if i in at else t for i, t in enumerate(args)]
        a32 = [t.float() if i in at else t for i, t in enumerate(a16)]
        pkw = {n: v for n, v in kw.items() if n == "t_in"}
        fn.dtypes = {}
        got = fn(*a16, **kw)
        grid, split = fn.last_grid, fn.last_split
        if got.dtype != dtype or fn.dtypes != {long_name: 1}:
            fail(f"{name} {short} at {shape_tag}: {got.dtype} output, "
                 f"launches {fn.dtypes}")
        err, sc = hold(f"{name} {short} at {shape_tag}", got.float(),
                       plain(*a16, **pkw).float(), rtol)
        if not torch.equal(fn(*a16, **kw), got):
            fail(f"{name} {short} at {shape_tag}: a rerun differs")
        mixed = [t.float() if i in at[1:] else t for i, t in enumerate(a16)]
        fn.dtypes = {}
        got_m = fn(*mixed, **kw)
        if got_m.dtype != dtype or fn.dtypes != {"float32": 1}:
            fail(f"{name} mixed ({short} x, float32 w, b) at {shape_tag}: "
                 f"{got_m.dtype} output, launches {fn.dtypes}")
        err_m, _ = hold(f"{name} mixed at {shape_tag}", got_m.float(),
                        plain(*mixed, **pkw).float(), rtol)
        if bf16:
            cluster, groups = kf.fused_cluster(split)
            layout = (f"grid {grid} (blocks of the split, O blocks, unit "
                      f"pairs), {groups} cluster(s) of {cluster} a tile")
        else:
            layout = (f"grid {grid} (rows, pixel blocks, O blocks, "
                      f"n_split) of the split-C body")
        print(f"[{tag}] {name} {short} at {shape_tag}: max|d| vs plain "
              f"{err:.3e} (limit {rtol:.4g}*{sc:.3f}), rerun bitwise equal, "
              f"{layout}; mixed x/w call through the float32 kernel "
              f"{err_m:.3e}")
        x, w = a16[at[0]], a16[at[1]]
        kk, c, o = w.shape
        entry = dict(
            source="src/repro_torch/csrc/" + (
                "dcn_fused_bf16.cuh" if bf16 else "dcn_fused_split.cuh"),
            max_abs_err=err,
            ms=cuda_time_ms(lambda: fn(*a16, **kw), 50),
            f32_kernel_ms=cuda_time_ms(lambda: fn(*a32, **kw), 50),
            plain_ms=cuda_time_ms(lambda: plain(*a16, **pkw), 5),
            library_ms=contraction(rows, args[at[1]]),
            ops=fused_ops(live, kk, c, o, "3xbf16" if bf16 else "2xtf32"),
            bytes=sum(t.numel() * t.element_size() for t in a16)
            + got.numel() * 2,
            shape=f"{short} {shape_tag}: x {tuple(x.shape)} w "
                  f"{tuple(w.shape)}, {live} live output pixels, {layout}")
        if bf16:
            entry.update(cluster=cluster, cluster_groups=groups)
        else:
            entry["library_fp16_ms"] = contraction(rows, w)
        kernels[name].setdefault(short, {})[
            ("" if bf16 else "fp16 ") + shape_tag] = entry
        del got, got_m, a16, a32, mixed


def half_dcn_phase(card, kernels, reset_counts, dcn, dtype) -> float:
    """Phase 14 (bf16) / 18a-b (float16): 16-bit DCN serving. 14a / 18a:
    ``half_dcn_kernels``. 14b / 18b: VGG19-3 DCN-II at 224x224, 1000
    classes, nothing cut, with phase 3's float32 weights rounded to
    ``dtype`` and ``GraphConfig(tile=8, schedule_backend="device")``:
    ``DcnServingEngine.infer`` on phase 3's images in batches of 4,
    ``run_graph`` (batch_fused) on the same batches, one image through
    ``batched`` and ``per_tile``; logits against ``run_graph_dense`` in
    ``dtype`` within the ``BF16_DCN`` rule (floor BF16_RTOL / F16_RTOL),
    every trace at 2 B a value equal to the simulator, every launch of
    #1 / #4 / #5 on the path one of ``dtype``. bf16: images/s of bf16 and
    float32 ``infer`` in turns, and one profiled ``infer`` of each for
    the device's idle share; float16: images/s of two float16 ``infer``
    runs beside 14b's bf16 median (``dcn["bf16_ips"]``). 14d / 18b: host
    images of ``dtype`` through ``submit`` / ``step()`` (bf16 tensors;
    float16 numpy arrays, whose logits come back numpy float16) and a
    degraded step. ``dcn`` carries phase 3's objects (params, cfg, graph,
    images) and phase 2's operands. -> the median images/s of the 16-bit
    ``infer`` runs."""
    import numpy as np
    import torch

    from repro_torch._tree import tree_map
    from repro_torch.core.simulator import simulate_network
    from repro_torch.kernels import dcn_fused as kf
    from repro_torch.models.dcn_models import apply_head
    from repro_torch.runtime import fused_exec as fx
    from repro_torch.runtime.cache import ScheduleCache
    from repro_torch.serving import DcnServingEngine

    dev, bf16, sz = torch.device("cuda"), dtype, BF16_DCN
    short, long_name = half_name(dtype), str(dtype).removeprefix("torch.")
    is_bf16 = dtype == torch.bfloat16
    tag = f"dcn-{short}"
    floor_rtol = BF16_RTOL if is_bf16 else F16_RTOL
    torch.cuda.empty_cache()
    half_dcn_kernels(kernels, dcn["ops"], dcn["contraction"],
                     dcn["fused_ops"], dtype)

    cfg, graph, images = dcn["cfg"], dcn["graph"], dcn["images"]
    params32 = dcn["params"]
    params = tree_map(lambda t: t.to(bf16), params32)
    gcfg = fx.GraphConfig(tile=8, schedule_backend="device")

    def x_of(lo, hi, dtype=bf16):
        return torch.as_tensor(images[lo:hi], device=dev).to(dtype)

    # The network's own bf16 error: the bf16 dense path against a float32
    # run of the same bf16 weights and images.
    ref16, ref32 = [], []
    p_wide = tree_map(lambda t: t.float(), params)
    for lo, hi in sz["batches"]:
        x = x_of(lo, hi)
        ref16.append(apply_head(params, cfg, fx.run_graph_dense(
            params["convs"], graph, x)))
        ref32.append(apply_head(p_wide, cfg, fx.run_graph_dense(
            p_wide["convs"], graph, x.float())))
    del p_wide
    r16, r32 = torch.cat(ref16), torch.cat(ref32)
    eps = float((r16.float() - r32).abs().max() / r32.abs().max())
    rtol = max(sz["noise_factor"] * eps, floor_rtol)
    print(f"[{tag}] VGG19-{cfg.n_deform} DCN-II {cfg.img_size}x"
          f"{cfg.img_size}, {cfg.num_classes} classes, phase 3's weights "
          f"rounded to {short}: the {short} dense path is {eps:.4e} of "
          f"max|ref| from the float32 run of the same weights; logits "
          f"limit max({sz['noise_factor']} x {eps:.4e}, {floor_rtol:.4g}) "
          f"= {rtol:.4e}")

    def check(what, logits, ref):
        if logits.dtype != bf16 or not torch.isfinite(logits.float()).all():
            fail(f"{what}: {logits.dtype} logits, or not finite")
        d, sc = rel_err(logits.float(), ref.float())
        if not d <= rtol * sc:
            fail(f"{what}: max|logit - dense {short}| = {d} > {rtol:.4e} * "
                 f"{sc}")
        return d / sc

    def check_traces(what, traces):
        for tr in traces:
            if {g.dtype_bytes for g in tr.groups} != {2}:
                fail(f"{what}: a group traced at "
                     f"{ {g.dtype_bytes for g in tr.groups} } B a value")
            sim = simulate_network(fx.network_sim_specs(tr),
                                   boundary_bytes=tr.boundary_bytes)
            if sim.total_dram_bytes != tr.total_dram_bytes:
                fail(f"{what}: trace DRAM {tr.total_dram_bytes} != "
                     f"simulator {sim.total_dram_bytes}")

    def only_bf16(what, fn):
        n = fn.launches
        if n <= 0 or fn.dtypes != {long_name: n}:
            fail(f"{what}: {fn.__name__} launches {n}, by type "
                 f"{fn.dtypes}; expected {short} launches only")
        return n

    def fresh_engine(p, dtype):
        eng = DcnServingEngine(p, cfg, slots=4, device=dev, graph=gcfg)
        eng.infer(x_of(*sz["warm"], dtype))      # cuDNN, conv schedules
        torch.cuda.synchronize()
        return eng

    def serve(eng, dtype):
        t0 = time.perf_counter()
        outs = [eng.infer(x_of(lo, hi, dtype)) for lo, hi in sz["batches"]]
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    # The main path: infer on the batches, every run_graph traced.
    eng = fresh_engine(params, bf16)
    traces = []
    orig = fx.run_graph

    def traced(*a, **k):
        out = orig(*a, **k)
        traces.append(out[1])
        return out

    reset_counts()
    for fn in (kf.dcn_fused_batch, kf.dcn_fused_schedule, kf.dcn_fused_tile):
        fn.dtypes = {}
    fx.run_graph = traced
    try:
        outs, wall = serve(eng, bf16)
    finally:
        fx.run_graph = orig
    n1 = only_bf16("infer", kf.dcn_fused_batch)
    worst = max(check(f"infer images {lo}-{hi - 1}", o, r) for o, r, (lo, hi)
                in zip(outs, ref16, sz["batches"]))
    if len(traces) != len(sz["batches"]):
        fail(f"infer ran run_graph {len(traces)} times for "
             f"{len(sz['batches'])} batches")
    check_traces("infer", traces)
    n_img = sum(hi - lo for lo, hi in sz["batches"])
    print(f"[{tag}] DcnServingEngine.infer in {short} on {n_img} images "
          f"in batches of 4: logits {short}, max rel. deviation from dense "
          f"{short} {worst:.4e} (limit {rtol:.4e}); {len(traces)} traces at "
          f"2 B a value == simulator; #1 launches {n1}, by type "
          f"{kf.dcn_fused_batch.dtypes}; {n_img / wall:.3f} images/s")
    entries = {n: kernels[n][short] for n in (
        "dcn_fused_batch", "dcn_fused_schedule", "dcn_fused_tile")}
    next(iter(entries["dcn_fused_batch"].values()))["launches"] = n1

    # run_graph in batch_fused on the same batches, with the trace.
    reset_counts()
    kf.dcn_fused_batch.dtypes = {}
    for (lo, hi), r in zip(sz["batches"], ref16):
        y, tr = fx.run_graph(params["convs"], graph, x_of(lo, hi),
                             config=gcfg, schedule_cache=ScheduleCache(),
                             return_trace=True)
        check(f"run_graph batch_fused images {lo}-{hi - 1}",
              apply_head(params, cfg, y), r)
        check_traces("run_graph batch_fused", [tr])
    n1g = only_bf16("run_graph batch_fused", kf.dcn_fused_batch)
    print(f"[{tag}] run_graph(dispatch='batch_fused') in {short} on the "
          f"same batches: logits within the limit, traces == simulator, "
          f"#1 launches {n1g}, by type {kf.dcn_fused_batch.dtypes}")

    # One image through batched (#4) and per_tile (#5).
    lo, hi = sz["one"]
    ref1 = apply_head(params, cfg, fx.run_graph_dense(
        params["convs"], graph, x_of(lo, hi)))
    for mode, fn in (("batched", kf.dcn_fused_schedule),
                     ("per_tile", kf.dcn_fused_tile)):
        reset_counts()
        fn.dtypes = {}
        t0 = time.perf_counter()
        y, tr = fx.run_graph(
            params["convs"], graph, x_of(lo, hi),
            config=dataclasses.replace(gcfg, dispatch=mode),
            schedule_cache=ScheduleCache(), return_trace=True)
        torch.cuda.synchronize()
        w_mode = time.perf_counter() - t0
        d = check(f"run_graph {mode}", apply_head(params, cfg, y), ref1)
        check_traces(f"run_graph {mode}", [tr])
        n = only_bf16(f"run_graph {mode}", fn)
        next(iter(entries[fn.__name__].values()))["launches"] = n
        print(f"[{tag}] run_graph(dispatch={mode!r}) in {short} on image "
              f"{lo}: {n} {fn.__name__} launches, all {short}, in "
              f"{w_mode:.2f} s; max rel. deviation from dense {short} "
              f"{d:.4e}; trace == simulator")

    # images/s of infer, float32 and bf16, in turns on fresh engines; then
    # one profiled infer call of each on a fresh engine, for the device's
    # idle share.
    if is_bf16:
        ips = {"bf16": [], "float32": []}
        for kind in ("float32", "bf16", "bf16", "float32") * sz["turns"]:
            p, dt = (params, bf16) if kind == "bf16" else (params32,
                                                           torch.float32)
            e = fresh_engine(p, dt)
            _, w = serve(e, dt)
            ips[kind].append(n_img / w)
            del e
        print(f"[dcn-bf16] {card}: DcnServingEngine.infer images/s, in "
              f"turns on fresh engines ({n_img} images in batches of 4, "
              f"{2 * sz['turns']} runs a dtype): bf16 median "
              f"{float(np.median(ips['bf16'])):.3f} "
              f"{[round(v, 3) for v in ips['bf16']]}, float32 median "
              f"{float(np.median(ips['float32'])):.3f} "
              f"{[round(v, 3) for v in ips['float32']]}; the checked bf16 "
              f"run above {n_img / wall:.3f}")
        for kind, p, dt in (("bf16", params, bf16),
                            ("float32", params32, torch.float32)):
            profile_infer(fresh_engine(p, dt), x_of(*sz["batches"][0], dt),
                          kind, card)
    else:
        e = fresh_engine(params, bf16)
        ips = {short: [n_img / serve(e, bf16)[1] for _ in range(2)]}
        del e
        print(f"[{tag}] {card}: DcnServingEngine.infer images/s in "
              f"{short} ({n_img} images in batches of 4, 2 runs on a warm "
              f"engine): {[round(v, 3) for v in ips[short]]}, median "
              f"{float(np.median(ips[short])):.3f}; 14b's bf16 median "
              f"{dcn['bf16_ips']:.3f} (no gain claimed: one call, the "
              f"runs not in turns)")

    # -- 14d: bf16 images through submit / step() ---------------------------
    from repro_torch.testing import FaultInjector

    lo, hi = sz["step_images"]
    host = [torch.as_tensor(images[k]).to(bf16) if is_bf16 else
            images[k].astype(np.float16) for k in range(lo, hi)]
    w_eng = fresh_engine(params, bf16)
    want = [w_eng.infer(x_of(a, a + 4)) for a in range(lo, hi, 4)]
    del w_eng
    torch.cuda.synchronize()
    traces.clear()
    eng = fresh_engine(params, bf16)
    reset_counts()
    kf.dcn_fused_batch.dtypes = {}
    fx.run_graph = traced
    try:
        t0 = time.perf_counter()
        reqs = [eng.submit(x) for x in host]
        done = eng.drain()
        wall = time.perf_counter() - t0
    finally:
        fx.run_graph = orig
    n1s = only_bf16("step()", kf.dcn_fused_batch)
    st = eng.stats
    if len(done) != len(reqs) or any(r.failed for r in reqs) or \
            st["step_retries"] or st["degraded_steps"]:
        fail(f"14d: {len(done)} of {len(reqs)} requests resolved, failed "
             f"{[r.rid for r in reqs if r.failed]}, retries "
             f"{st['step_retries']}, degraded {st['degraded_steps']}")
    res = [r.result() for r in reqs]
    if not is_bf16 and not all(isinstance(r, np.ndarray) for r in res):
        fail(f"18b: a float16 engine's step() gave {type(res[0])}, not the "
             f"numpy logits np.asarray gives in the JAX engine")
    got = torch.cat([torch.as_tensor(r) for r in res])
    if got.dtype != bf16 or got.device.type != "cpu" or \
            not torch.equal(got, torch.cat(want).cpu()):
        fail(f"step(): logits ({got.dtype} on {got.device}) differ from "
             f"{short} infer on the same batches")
    if len(traces) != (hi - lo) // 4:
        fail(f"14d: {len(traces)} steps for {hi - lo} images in 4 slots")
    check_traces("step()", traces)
    step_ips = (hi - lo) / wall
    print(f"[{tag}] {card}: {'14d' if is_bf16 else '18b'} "
          f"DcnServingEngine.submit / step() in {short}: {hi - lo} "
          f"requests of one host {short} image "
          f"({'torch tensors' if is_bf16 else 'numpy arrays'}), "
          f"{len(traces)} steps: logits {short} on the host "
          f"({type(res[0]).__name__}), bitwise {short} infer on the same "
          f"batches; traces at 2 B a value == simulator; #1 launches "
          f"{n1s}, by type {kf.dcn_fused_batch.dtypes}; {step_ips:.3f} "
          f"images/s (infer {short} median "
          f"{float(np.median(ips[short])):.3f})")
    # The degraded step: an untagged fault sends the step to per-image
    # batched dispatch, #4's bf16 body.
    reset_counts()
    kf.dcn_fused_schedule.dtypes = {}
    eng = DcnServingEngine(params, cfg, slots=4, device=dev, graph=gcfg,
                           faults=FaultInjector(kinds=("dispatch",), rate=1.0,
                                                max_fires=1, tag_image=False))
    reqs = [eng.submit(x) for x in host[:4]]
    eng.drain()
    if eng.stats["degraded_steps"] != 1 or any(r.failed for r in reqs):
        fail(f"14d degraded: {eng.stats['degraded_steps']} degraded steps, "
             f"failed {[r.rid for r in reqs if r.failed]}")
    n4 = only_bf16("degraded step()", kf.dcn_fused_schedule)
    d = check("degraded step()", torch.cat(
        [torch.as_tensor(r.result()) for r in reqs]).to(dev), ref16[0])
    check_traces("degraded step()", [eng.last_trace])
    print(f"[{tag}] degraded step in {short}: 4 images through "
          f"{n4} dcn_fused_schedule launches, all {short}; max rel. "
          f"deviation from dense {short} {d:.4e} (limit {rtol:.4e}); trace "
          f"== simulator")
    del eng, params, ref16, ref32, r16, r32, want
    torch.cuda.empty_cache()
    return float(np.median(ips[short]))


def profile_infer(eng, x, what: str, card: str) -> None:
    """One ``infer`` call on a fresh engine's unseen images under
    ``torch.profiler``: wall time, device busy time and idle share, and the
    top device activities."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.infer(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, by_name = device_busy(prof.events())
    if busy_us <= 0:
        fail(f"the profiler recorded no device activity in a {what} infer")
    print(f"[dcn-bf16] {card}: one {what} infer of {len(x)} unseen images "
          f"under the profiler: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms (idle {100 * (1 - busy_us / wall_us):.1f}"
          f" %)")
    for name, d in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:5]:
        print(f"  device {sum(d) / 1e3:8.2f} ms x{len(d):<5d} {name[:90]}")


def bf16_cache_phase() -> None:
    """Phase 14c: a bf16 model over a float32 cache (the engines' default
    ``cache_dtype``). The llama-3.2-vision smoke model's first self and
    first cross layer in bf16, ``attention_decode`` over a float32 cache
    on the card (#8 with ``round_kv``) against the CPU path (the JAX
    cast of the cache to bf16) within BF16_RTOL * max|ref|; and #8 over a
    float32 cache whose values lie within 0.2 bf16 ulp of bf16 numbers,
    under a float32 q, against #8 over those bf16 numbers within 1e-5 *
    max|ref|, where the unrounded read moves the result by more."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import layers, lm
    from repro_torch.models.transformer import layer_slices

    sz, bf16 = BF16_CACHE, torch.bfloat16
    cfg = configs.get_config(sz["arch"], smoke=True)
    params = lm.init_lm(cfg, SEED, device="cpu", dtype=bf16)
    rng = np.random.default_rng(SEED + 16)
    pos = torch.tensor(sz["pos"], dtype=torch.int32)
    kinds = [s.cross for s in cfg.pattern]
    if not (cfg.n_repeats and True in kinds and False in kinds):
        fail(f"{cfg.name} smoke has no self and cross layer in its stack")
    for kind, idx in (("self", kinds.index(False)),
                      ("cross", kinds.index(True))):
        acfg = cfg.attn_cfg(cfg.pattern[idx])
        p = layer_slices(params["layers"]["stack"][f"b{idx}"])[0]["attn"]
        cache = layers.init_kv_cache(acfg, sz["batch"], sz["max_len"],
                                     dtype=torch.float32)
        g = torch.Generator().manual_seed(SEED + 17 + idx)
        cache["k"].normal_(generator=g)
        cache["v"].normal_(generator=g)
        card_cache = {n: t.cuda() for n, t in cache.items()}
        x = torch.as_tensor(rng.normal(size=(sz["batch"], 1, cfg.d_model))
                            .astype(np.float32)).to(bf16)
        want, _ = layers.attention_decode(p, acfg, x, cache, pos)
        fd.flash_decode.dtypes = {}
        got, _ = layers.attention_decode(
            {n: t.cuda() for n, t in p.items()}, acfg, x.cuda(), card_cache,
            pos.cuda())
        if fd.flash_decode.dtypes != {"bfloat16/float32": 1}:
            fail(f"bf16 {kind} layer over a float32 cache launched #8 "
                 f"{fd.flash_decode.dtypes}")
        err, sc = hold(f"bf16 {kind} layer over a float32 cache, card vs "
                       f"CPU", got.float().cpu(), want.float(), BF16_RTOL)
        print(f"[cache-bf16] {cfg.name}, bf16 {kind} layer {idx} over a "
              f"float32 cache: attention_decode on the card (#8, round_kv) "
              f"vs the CPU path (cache cast to bf16): max|d| {err:.3e} "
              f"(limit {BF16_RTOL:.4g}*{sc:.3f})")
    b, s, hq, hkv, d = 4, 512, 16, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    q = torch.randn((b, hq, d), generator=gen, device="cuda")
    lens = torch.tensor([512, 300, 64, 1], dtype=torch.int32, device="cuda")
    caches = []
    for _ in range(2):
        kb = torch.randn((b, s, hkv, d), generator=gen,
                         device="cuda").to(bf16)
        ulp = torch.ldexp(torch.ones_like(kb, dtype=torch.float32),
                          torch.floor(torch.log2(kb.float().abs())).int() - 7)
        nudge = 0.2 * ulp * (2 * torch.rand(kb.shape, generator=gen,
                                            device="cuda").round() - 1)
        caches.append((kb, kb.float() + torch.where(kb == 0, 0, nudge)))
    (kb, kf32), (vb, vf32) = caches
    if not (torch.equal(kf32.to(bf16), kb) and torch.equal(vf32.to(bf16),
                                                           vb)):
        fail("the nudged float32 cache does not round to its bf16 values")
    want = fd.flash_decode(q, kb, vb, lens)
    got = fd.flash_decode(q, kf32, vf32, lens, round_kv=torch.bfloat16)
    unrounded = fd.flash_decode(q, kf32, vf32, lens)
    err, sc = hold("#8 round_kv over a nudged float32 cache vs the bf16 "
                   "cache", got, want, 1e-5)
    moved, _ = rel_err(unrounded, want)
    if not moved > 1e-5 * sc:
        fail(f"the unrounded read moved the result by only {moved}: the "
             f"check cannot see the rounding")
    print(f"[cache-bf16] #8 round_kv over a float32 cache within 0.2 ulp of "
          f"bf16 values, float32 q: max|d| vs the bf16 cache {err:.3e} "
          f"(limit 1e-5*{sc:.3f}); without round_kv {moved:.3e}")


def mesh_phase(card, reset_counts) -> None:
    """Phase 15: the mesh's "model" axis, every shard on this card (a mesh
    that lists it several times: no copy between devices happens, and none
    is measured). 15a: granite-moe ``full()`` served by a
    ``DecodeEngine(mesh=)`` over a (1, ep) mesh beside an unsharded engine
    on the same weights, in lockstep; ``moe_apply(mesh=)`` over (2, ep) in
    both weight modes. 15b: Qwen3-1.7B ``full()`` through ``build_step``
    over (2, 2): prefill through #7 and decode through #8 on every rank's
    slice. 15c: ``launch.serve`` on ``make_host_mesh(1, 1)``."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models import layers, lm, moe
    from repro_torch.models.params import ShardedTree, param_bytes
    from repro_torch.serving import DecodeEngine, Request

    dev, sz, sync = torch.device("cuda"), MESH_SIZES, torch.cuda.synchronize

    # -- 15a: expert parallelism ---------------------------------------------
    torch.cuda.empty_cache()
    cfg = configs.get_config(sz["granite"])
    params = lm.init_lm(cfg, SEED, device=dev)
    d_ep, m_ep = sz["ep_mesh"]
    if m_ep != cfg.moe.ep:
        fail(f"{cfg.name}: ep {cfg.moe.ep}, mesh model size {m_ep}")
    mesh = DeviceMesh.on("cuda:0", data=d_ep, model=m_ep)
    print(f"[mesh-ep] {cfg.name} full(): {param_bytes(params) / 1e9:.2f} GB "
          f"of float32 params; {cfg.moe.n_experts_padded} padded experts, "
          f"{cfg.moe.e_loc} a rank over DeviceMesh.on(cuda:0, data={d_ep}, "
          f"model={m_ep})")
    rng = np.random.default_rng(SEED + 15)
    prompts = [rng.integers(0, cfg.vocab, size=sz["prompt_len"]).tolist()
               for _ in range(sz["requests"])]
    engines = {
        name: DecodeEngine(params, cfg, batch=sz["requests"],
                           max_len=sz["max_len"], device=dev, mesh=m)
        for name, m in (("unsharded", None), ("mesh", mesh))}
    for eng in engines.values():
        for rid, prompt in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=list(prompt),
                               max_new=sz["max_new"]))
    logits_of, orig = {}, lm.lm_decode_step

    def spy(p, c, cache, token, pos, ctx=None):
        out = orig(p, c, cache, token, pos, ctx)
        logits_of["mesh" if ctx else "unsharded"] = out[0]
        return out

    step_s = {name: [] for name in engines}
    n8 = {name: [] for name in engines}
    worst, resynced = 0.0, []
    ref_eng, mesh_eng = engines["unsharded"], engines["mesh"]
    # The mesh engine's #8 calls of its first and last attention layer at
    # one step, held against the plain version after the run.
    n_attn, held8 = attn_layers(cfg), []
    ends = (0, n_attn - 1)

    def keep8():
        return fd.flash_decode.launches - 1 in ends

    lm.lm_decode_step = spy
    try:
        while True:
            active, before = {}, list(mesh_eng.slots)
            for name, eng in engines.items():
                held = name == "mesh" and eng.steps == sz["held_step"]
                fd.flash_decode.launches = 0
                t0 = time.perf_counter()
                with recording(layers, "flash_decode", held8, keep=keep8) \
                        if held else contextlib.nullcontext():
                    active[name] = eng.step()
                sync()
                step_s[name].append(time.perf_counter() - t0)
                n8[name].append(fd.flash_decode.launches)
            ref = logits_of["unsharded"]
            d, sc = hold(f"15a step {ref_eng.steps} logits (mesh engine vs "
                         f"unsharded)", logits_of["mesh"], ref,
                         sz["step_rtol"])
            worst = max(worst, d / sc)
            for i, req in enumerate(before):
                got = int(mesh_eng.pending_tok[i].reshape(-1)[0])
                want = int(ref_eng.pending_tok[i].reshape(-1)[0])
                if req is None or got == want:
                    continue
                top = torch.topk(ref[i, 0], 2).values
                gap = float(top[0] - top[1])
                tol = sz["gap_rtol"] * float(ref[i, 0].abs().max())
                if gap > tol:
                    fail(f"15a step {ref_eng.steps} slot {i}: token {got} "
                         f"vs {want} with top-2 gap {gap} > {tol}")
                # A near tie: resynchronise, so the logits stay comparable.
                mesh_eng.pending_tok[i] = want
                req.out[-1] = want
                resynced.append((ref_eng.steps, i, gap))
            if active["unsharded"] != active["mesh"]:
                fail(f"15a: {active} slots active after a step")
            if active["unsharded"] == 0 and not ref_eng.queue:
                break
    finally:
        lm.lm_decode_step = orig
    outs = {name: {r.rid: r.out for r in eng.finished}
            for name, eng in engines.items()}
    if outs["mesh"] != outs["unsharded"] or len(outs["mesh"]) != len(prompts):
        fail(f"15a tokens: {outs}")
    if any(len(o) != sz["max_new"] for o in outs["mesh"].values()):
        fail(f"15a: requests did not finish with max_new tokens: {outs}")
    p50 = {name: float(np.percentile(v, 50)) * 1e3
           for name, v in step_s.items()}
    print(f"[mesh-ep] {card}: {len(prompts)} requests x {sz['max_new']} new "
          f"tokens (prompts of {sz['prompt_len']}) in {ref_eng.steps} "
          f"steps of batch {ref_eng.batch}; step p50 unsharded "
          f"{p50['unsharded']:.2f} ms, mesh {p50['mesh']:.2f} ms; "
          f"flash_decode launches a step {sorted(set(n8['unsharded']))} / "
          f"{sorted(set(n8['mesh']))}; step logits max|d| {worst:.3e} of "
          f"max|ref| (limit {sz['step_rtol']}); tokens equal"
          + (f", resynchronised at near ties {resynced}" if resynced else ""))
    if set(n8["mesh"]) != {n_attn}:
        fail(f"15a: the mesh engine launched flash_decode {n8['mesh']} "
             f"times a step, not {n_attn}")
    if len(held8) != len(ends):
        fail(f"15a: kept {len(held8)} flash_decode calls at step "
             f"{sz['held_step']}, not {len(ends)}")
    for layer, (a, _, _), (d, sc) in zip(ends, held8, hold_captured(
            "15a flash_decode on the mesh engine's operands", held8,
            fd.flash_decode_plain)):
        print(f"[mesh-ep] flash_decode of the mesh engine at step "
              f"{sz['held_step']}, attention layer {layer} of {n_attn} (q "
              f"{tuple(a[0].shape)}, cache {tuple(a[1].shape)}, lengths "
              f"{a[3].tolist()}) vs plain: max|d| {d:.3e} (limit "
              f"{ATTN_RTOL}*{sc:.3f})")
    del engines, ref_eng, mesh_eng, logits_of, held8

    layer0 = {k: v[0] for k, v in params["layers"]["stack"]["b0"][
        "moe"].items()}
    on_cpu = {k: v.cpu() for k, v in layer0.items()}
    x = torch.randn((sz["requests"], 1, cfg.d_model),
                    generator=torch.Generator().manual_seed(SEED + 15))
    d2, m2 = sz["moe_mesh"]
    mesh2 = DeviceMesh.on("cuda:0", data=d2, model=m2)
    cpu2 = DeviceMesh.on("cpu", data=d2, model=m2)
    for mode in ("fsdp", "tp_f"):
        mcfg = dataclasses.replace(cfg.moe, weight_mode=mode)
        free = no_drops(dataclasses.replace(cfg, moe=mcfg)).moe
        got, aux = moe.moe_apply(layer0, free, x.to(dev), mesh=mesh2)
        want, aux_w = moe.moe_apply(layer0, free, x.to(dev))
        d_free, sc = hold(f"15a moe_apply({mode}) over ({d2}, {m2}) vs "
                          f"unsharded", got, want, sz["step_rtol"])
        got, aux = moe.moe_apply(layer0, mcfg, x.to(dev), mesh=mesh2)
        want, aux_c = moe.moe_apply(on_cpu, mcfg, x, mesh=cpu2)
        d_cpu, _ = hold(f"15a moe_apply({mode}) over ({d2}, {m2}) vs the CPU "
                        f"mesh", got.cpu(), want, sz["step_rtol"])
        d_aux = abs(float(aux) - float(aux_c))
        if not d_aux <= sz["aux_rtol"] * abs(float(aux_c)):
            fail(f"15a moe_apply({mode}) aux {float(aux)} vs the CPU "
                 f"mesh's {float(aux_c)}: |d| {d_aux} > {sz['aux_rtol']}"
                 f"*|ref|")
        print(f"[mesh-ep] moe_apply(weight_mode={mode}) of layer 0 at the "
              f"decode shape {tuple(x.shape)} over DeviceMesh.on(cuda:0, "
              f"data={d2}, model={m2}): vs unsharded (capacity factor "
              f"{free.capacity_factor:g}, nothing drops) max|d| "
              f"{d_free:.3e}; at the config's factor "
              f"{mcfg.capacity_factor:g} vs the same call over the CPU mesh "
              f"max|d| {d_cpu:.3e} (limit {sz['step_rtol']}*{sc:.3f}); aux "
              f"{float(aux):.6f} vs {float(aux_c):.6f}, |d| {d_aux:.3e} "
              f"(limit {sz['aux_rtol']}*|ref|)")
    del params, layer0, on_cpu
    torch.cuda.empty_cache()

    # -- 15b: tensor parallelism ---------------------------------------------
    cfg = dataclasses.replace(configs.get_config(sz["qwen"]), use_flash=True)
    if cfg.prefix or len(cfg.pattern) != 1:
        fail(f"15b expects one stacked block kind, got {cfg.pattern}")
    params = lm.init_lm(cfg, SEED, device=dev)
    d_tp, m_tp = sz["tp_mesh"]
    mesh = DeviceMesh.on("cuda:0", data=d_tp, model=m_tp)
    pb, plen = sz["prefill"]
    steps = sz["decode_steps"]
    pre = build_step(cfg, ShapeCell("p", "prefill", plen, pb), mesh,
                     param_dtype=torch.float32)
    dec = build_step(cfg, ShapeCell("d", "decode", plen + steps, pb), mesh,
                     param_dtype=torch.float32)
    placed = ShardedTree.place(params, pre.param_shardings, mesh)
    rank = placed.shards[1][1]
    blk = rank["layers"]["stack"]["b0"]
    per_rank = dict(q_heads=blk["attn"]["wq"].shape[2],
                    kv_heads=blk["attn"]["wk"].shape[2],
                    mlp_columns=blk["mlp"]["w_up"].shape[2],
                    vocab_rows=(rank["embed"].shape[1]))
    want_rank = dict(q_heads=cfg.n_heads // m_tp,
                     kv_heads=cfg.n_kv_heads // m_tp,
                     mlp_columns=cfg.d_ff // m_tp,
                     vocab_rows=cfg.vocab // m_tp)
    if per_rank != want_rank:
        fail(f"15b rank (1, 1) holds {per_rank}, expected {want_rank}")
    print(f"[mesh-tp] {cfg.name} full() over DeviceMesh.on(cuda:0, "
          f"data={d_tp}, model={m_tp}): each rank holds {per_rank} (views "
          f"of the {param_bytes(params) / 1e9:.2f} GB of float32 params: "
          f"one card)")
    prng = np.random.default_rng(SEED + 6)
    toks = torch.as_tensor(prng.integers(0, cfg.vocab, size=(pb, plen))
                           .astype(np.int32), device=dev)
    pre.fn(placed, {"tokens": toks[:, :64]})                    # warm-up
    sync()
    # #7's calls of the first and the last layer (every row and rank),
    # held against the plain version after the run.
    n_rk, ends = d_tp * m_tp, (0, cfg.n_layers - 1)
    held7 = []
    reset_counts()
    t0 = time.perf_counter()
    with recording(layers, "flash_attention", held7, keep=lambda: (
            (fa.flash_attention.launches - 1) // n_rk in ends)):
        got = pre.fn(placed, {"tokens": toks})
    sync()
    wall = time.perf_counter() - t0
    n7 = fa.flash_attention.launches
    if n7 != cfg.n_layers * d_tp * m_tp:
        fail(f"15b prefill launched flash_attention {n7} times, not "
             f"{cfg.n_layers} x {d_tp * m_tp}")
    kv, orig7 = [], layers.flash_attention

    def keep_kv(q, k, v, **kw):
        kv.append((k, v))
        return orig7(q, k, v, **kw)

    layers.flash_attention = keep_kv
    try:
        t0 = time.perf_counter()
        ref = lm.lm_prefill(params, cfg, {"tokens": toks})
        sync()
        wall_ref = time.perf_counter() - t0
    finally:
        layers.flash_attention = orig7
    d, sc = hold("15b prefill logits (build_step over the mesh vs "
                 "unsharded)", got, ref, LOGIT_RTOL)
    print(f"[mesh-tp] {card}: prefill {pb} x {plen} tokens through {n7} "
          f"flash_attention launches ({cfg.n_layers} layers x {d_tp} rows x "
          f"{m_tp} ranks) in {wall * 1e3:.1f} ms = {pb * plen / wall:.0f} "
          f"tokens/s (unsharded {wall_ref * 1e3:.1f} ms = "
          f"{pb * plen / wall_ref:.0f} tokens/s); logits max|d| {d:.3e} "
          f"(limit {LOGIT_RTOL}*{sc:.3f})")
    if len(held7) != len(ends) * n_rk:
        fail(f"15b: kept {len(held7)} prefill calls of flash_attention, not "
             f"{len(ends) * n_rk}")
    for n, ((a, k, _), (d, sc)) in enumerate(zip(held7, hold_captured(
            "15b flash_attention on a rank's prefill operands", held7,
            fa.flash_attention_plain))):
        print(f"[mesh-tp] flash_attention at layer {ends[n // n_rk]} of "
              f"{cfg.n_layers}, row {n % n_rk // m_tp} rank {n % m_tp} (q "
              f"{tuple(a[0].shape)}, k {tuple(a[1].shape)}, {k}) vs plain: "
              f"max|d| {d:.3e} (limit {ATTN_RTOL}*{sc:.3f})")
    del held7

    # The cache of the prompts: each layer's K / V as the prefill made them.
    cache = lm.init_cache(cfg, pb, plen + steps, dtype=torch.float32,
                          device=dev)
    for r, (k, v) in enumerate(kv):
        cache["stack"]["b0"]["mix"]["k"][r, :, :plen] = k
        cache["stack"]["b0"]["mix"]["v"][r, :, :plen] = v
    del kv
    tok = torch.argmax(ref[:, 0], -1, keepdim=True).to(torch.int32)
    pos = torch.full((pb,), plen, dtype=torch.int32, device=dev)
    ptrs, orig8, sharded_call = set(), layers.flash_decode, [False]

    def spy8(q, kc, vc, *a, **kw):
        if sharded_call[0]:
            ptrs.update([kc.data_ptr(), vc.data_ptr()])
        return orig8(q, kc, vc, *a, **kw)

    placed_cache, worst, t_tp, t_ref, n8 = cache, 0.0, [], [], set()
    held8, held_at = [], (0, steps - 1)
    layers.flash_decode = spy8
    try:
        for step in range(steps):
            fd.flash_decode.launches = 0
            sharded_call[0] = True
            t0 = time.perf_counter()
            with recording(layers, "flash_decode", held8, keep=lambda: (
                    (fd.flash_decode.launches - 1) // n_rk in ends)) \
                    if step in held_at else contextlib.nullcontext():
                got, placed_cache = dec.fn(placed, placed_cache, tok, pos)
            sync()
            t_tp.append(time.perf_counter() - t0)
            sharded_call[0] = False
            n8.add(fd.flash_decode.launches)
            t0 = time.perf_counter()
            want, cache = lm.lm_decode_step(params, cfg, cache, tok, pos)
            sync()
            t_ref.append(time.perf_counter() - t0)
            d, sc = hold(f"15b decode step {step} logits", got, want,
                         sz["decode_rtol"])
            worst = max(worst, d / sc)
            tok = torch.argmax(want[:, 0], -1, keepdim=True).to(torch.int32)
            pos = pos + 1
    finally:
        layers.flash_decode = orig8
    own = cache_kv_ptrs(placed_cache.shards)
    n_tp = cfg.n_layers * d_tp * m_tp
    if n8 != {n_tp} or not ptrs <= own:
        fail(f"15b: flash_decode launches a step {n8} (expected {n_tp}), "
             f"{len(ptrs - own)} cache pointers not the rank caches'")
    p50_tp = float(np.percentile(t_tp, 50))
    p50_ref = float(np.percentile(t_ref, 50))
    print(f"[mesh-tp] {card}: {steps} decode steps of batch {pb} from the "
          f"{plen}-token prompts: {n_tp} flash_decode launches a step, each "
          f"on its rank's cache slice (data pointers of the ShardedCache, "
          f"no copy); step p50 {p50_tp * 1e3:.2f} ms = {pb / p50_tp:.1f} "
          f"tokens/s (unsharded {p50_ref * 1e3:.2f} ms = "
          f"{pb / p50_ref:.1f} tokens/s; no gain is claimed: one card); "
          f"logits max|d| {worst:.3e} of max|ref| (limit "
          f"{sz['decode_rtol']})")
    if len(held8) != len(held_at) * len(ends) * n_rk:
        fail(f"15b: kept {len(held8)} decode calls of flash_decode, not "
             f"{len(held_at) * len(ends) * n_rk}")
    for n, ((a, _, _), (d, sc)) in enumerate(zip(held8, hold_captured(
            "15b flash_decode on a rank's cache slice", held8,
            fd.flash_decode_plain))):
        at = n // (len(ends) * n_rk)
        print(f"[mesh-tp] flash_decode at step {held_at[at]}, layer "
              f"{ends[n // n_rk % len(ends)]} of {cfg.n_layers}, row "
              f"{n % n_rk // m_tp} rank {n % m_tp} (q {tuple(a[0].shape)}, "
              f"cache {tuple(a[1].shape)}, lengths {a[3].tolist()}) vs "
              f"plain: max|d| {d:.3e} (limit {ATTN_RTOL}*{sc:.3f})")
    del params, placed, placed_cache, cache, ref, got, want, held8
    torch.cuda.empty_cache()

    # -- 15c: launch.serve on make_host_mesh(1, 1) ----------------------------
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         sz["granite"]], env=env, capture_output=True, text=True,
        timeout=600, cwd=ROOT)
    if proc.returncode != 0:
        fail(f"15c: launch.serve exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    print(f"[mesh-serve] python -m repro_torch.launch.serve --arch "
          f"{sz['granite']} (smoke config, make_host_mesh(1, 1)) exited 0 "
          f"in {time.perf_counter() - t0:.1f} s: "
          + proc.stdout.strip().splitlines()[0])


def mesh_train_phase(card: str, wrappers: dict) -> None:
    """Phase 16: Qwen3-1.7B ``full()`` training, ``remat="dots"``, over
    ``DeviceMesh.on("cuda:0", data=2, model=2)`` through
    ``build_step(kind="train")`` beside the unsharded ``build_train_step``
    from the same seed and batches. The unsharded run goes first (its
    step-0 per-tensor gradient norms and its losses kept on the host) and
    is freed, so the two never hold memory together. Held: the losses
    within ``rtol`` relative, every tensor's step-0 gradient norm within
    ``rtol`` relative (the logical gradient: each slice's holders'
    parts summed), no hand-written kernel launched; printed: step p50 of
    both, the mesh run's peak allocated memory, one profiled mesh step's
    device idle share."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch._tree import flatten_with_names, value_and_grad
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data import DataConfig, token_batch
    from repro_torch.launch.mesh import DeviceMesh
    from repro_torch.launch.steps import (build_step, build_train_step,
                                          value_and_grad_placed)
    from repro_torch.models import lm
    from repro_torch.models.params import ShardedTree, param_bytes
    from repro_torch.optim import AdamWConfig, init_opt_state

    dev, sync, sz = torch.device("cuda"), torch.cuda.synchronize, MESH_TRAIN
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(configs.get_config(sz["arch"]), remat="dots")
    ocfg = AdamWConfig(lr=sz["lr"], warmup_steps=1, total_steps=sz["steps"])
    dcfg = DataConfig(seed=SEED, vocab=cfg.vocab, seq=sz["seq"],
                      global_batch=sz["batch"])
    batches = [token_batch(dcfg, s) for s in range(sz["steps"])]
    first = {"tokens": torch.as_tensor(batches[0]["tokens"], device=dev)}

    def timed_steps(step, params, opt):
        losses, times = [], []
        for b in batches:
            sync()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
        return params, opt, losses, times

    # The unsharded step first; only host numbers are kept.
    for w in wrappers.values():
        w.launches = 0
    params = lm.init_lm(cfg, SEED, device=dev)
    pb = param_bytes(params)
    _, g = value_and_grad(lambda p: lm.lm_loss(p, cfg, first), params)
    ref_norms = {n: float(t.norm()) for n, t in flatten_with_names(g)}
    del g
    params, opt, ref_losses, ref_times = timed_steps(
        build_train_step(cfg, ocfg), params, init_opt_state(params, ocfg))
    del params, opt
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase

    d, m = sz["mesh"]
    mesh = DeviceMesh.on("cuda:0", data=d, model=m)
    bundle = build_step(cfg, ShapeCell("train", "train", sz["seq"],
                                       sz["batch"]), mesh, opt_cfg=ocfg,
                        param_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    placed = ShardedTree.place(lm.init_lm(cfg, SEED, device=dev),
                               bundle.param_shardings, mesh)
    _, g = value_and_grad_placed(
        lambda p: lm.lm_loss(p, cfg, first, {"mesh": mesh}), placed)
    norms = {n: float(t.norm()) for n, t in flatten_with_names(g.whole(0))}
    del g
    placed, opt, losses, times = timed_steps(
        bundle.fn, placed, init_opt_state(placed, ocfg))
    peak = torch.cuda.max_memory_allocated() - base
    no_kernel_launched("training over the mesh", wrappers)
    bad = [(s, a, b) for s, (a, b) in enumerate(zip(losses, ref_losses))
           if not abs(a - b) <= sz["rtol"] * abs(b)]
    if bad or not all(math.isfinite(v) for v in losses):
        fail(f"16: mesh losses {losses} vs unsharded {ref_losses}")
    if set(norms) != set(ref_norms):
        fail("16: the mesh's gradient tree has other leaves")
    worst = max(abs(norms[n] - ref_norms[n]) / max(ref_norms[n], 1e-30)
                for n in norms)
    if not worst <= sz["rtol"]:
        fail(f"16: a tensor's gradient norm is {worst:.3e} relative from "
             f"the unsharded one's (limit {sz['rtol']})")
    toks = sz["batch"] * sz["seq"]

    def ms(ts):
        return [round(t * 1e3, 1) for t in ts]

    print(f"[mesh-train] {card}: {cfg.name} full() {cfg.n_layers} layers, "
          f"remat='dots', float32 params {pb / 1e9:.2f} GB, {sz['steps']} "
          f"steps of {sz['batch']} x {sz['seq']} over "
          f"DeviceMesh.on(cuda:0, data={d}, model={m}) beside the unsharded "
          f"step: losses {losses} vs {ref_losses}; step-0 gradient norms of "
          f"{len(norms)} tensors within {worst:.3e} relative (limit "
          f"{sz['rtol']}); step p50 {np.median(times) * 1e3:.1f} ms "
          f"({toks / np.median(times):.0f} tokens/s) vs unsharded "
          f"{np.median(ref_times) * 1e3:.1f} ms; steps {ms(times)} vs "
          f"{ms(ref_times)} ms; mesh peak allocated {peak / 1e9:.2f} GB "
          f"above the "
          f"{base / 1e9:.2f} GB held before it")
    t_mesh = time.perf_counter() - t_phase
    profile_train(f"Qwen3-1.7B training step of {toks} tokens over the "
                  f"({d}, {m}) mesh", lambda: bundle.fn(placed, opt,
                                                        batches[0]), card)
    del placed, opt
    torch.cuda.empty_cache()
    print(f"[mesh-train] phase 16 took {time.perf_counter() - t_phase:.1f} "
          f"s: the unsharded run to {t_ref:.1f} s, the mesh run to "
          f"{t_mesh:.1f} s, then the profiled step")


def dryrun_phase(card: str) -> None:
    """Phase 17: the dry run of Qwen3-1.7B ``full()`` (float32 params,
    ``use_flash=True``) over a (2, 2) mesh of ``meta`` devices
    (``launch.mesh.meta_mesh``, ``launch.op_analysis.analyze_step`` on
    ``StepBundle.args_abstract``) beside the same steps run on
    ``DeviceMesh.on("cuda:0", 2, 2)``: prefill and one decode step.
    Held, exactly: the dry run's #7 / #8 launches to the wrappers' counts
    over the real step (one a layer, row and rank); its aten FLOPs (the
    kernels' charged FLOPs left out) summed over the devices to
    ``FlopCounterMode`` around the real step; each device's argument
    bytes to the bytes of rank (i, r)'s held slices and inputs. Then the
    (1, 1) dry run's prefill memory beside the card's
    ``max_memory_allocated`` rise over the same step (warm), its peak
    within ``mem_rtol``."""
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import configs
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.launch.mesh import DeviceMesh, meta_mesh
    from repro_torch.launch.op_analysis import analyze_step
    from repro_torch.launch.steps import build_step
    from repro_torch.models import lm
    from repro_torch.models.params import ShardedTree, leaves
    from repro_torch.models.transformer import cache_split, shard_cache

    dev, sync, sz = torch.device("cuda"), torch.cuda.synchronize, DRYRUN
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(configs.get_config(sz["arch"]), use_flash=True)
    params = lm.init_lm(cfg, SEED, device=dev)
    rng = np.random.default_rng(SEED + 17)
    wrapper = {"prefill": fa.flash_attention, "decode": fd.flash_decode}
    kernel = {"prefill": "flash_attention", "decode": "flash_decode"}

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in leaves(tree)
                   if t is not None)

    def cell(kind):
        b, s = sz[kind]
        return ShapeCell(kind, kind, s, b)

    def dry(kind, d, m):
        mesh = meta_mesh(d, m)
        bundle = build_step(cfg, cell(kind), mesh, param_dtype=torch.float32)
        t0 = time.perf_counter()
        out = analyze_step(bundle.fn, *bundle.args_abstract, mesh=mesh)
        return out, time.perf_counter() - t0

    def real(kind, d, m):
        """The step on the card, its arguments and each rank's bytes."""
        mesh = DeviceMesh.on("cuda:0", data=d, model=m)
        bundle = build_step(cfg, cell(kind), mesh, param_dtype=torch.float32)
        placed = ShardedTree.place(params, bundle.param_shardings, mesh)
        want = [nbytes(placed.shards[i][r]) for i in range(d)
                for r in range(m)]
        b, s = sz[kind]
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(
            b, s if kind == "prefill" else 1)).astype(np.int32), device=dev)
        if kind == "prefill":
            want[0] += nbytes(toks)
            return bundle.fn, (placed, {"tokens": toks}), want
        # A bf16 cache, as the dry run's stand-in (``input_specs``).
        cache = shard_cache(cfg, lm.init_cache(cfg, b, s, device=dev), mesh,
                            cache_split(placed["layers"], cfg))
        pos = torch.full((b,), s // 2, dtype=torch.int32, device=dev)
        want = [w + nbytes(cache.shards[k // m][k % m])
                for k, w in enumerate(want)]
        want[0] += nbytes(toks) + nbytes(pos)
        return bundle.fn, (placed, cache, toks, pos), want

    d, m = sz["mesh"]
    for kind in ("prefill", "decode"):
        ana, trace_s = dry(kind, d, m)
        fn, args, want = real(kind, d, m)
        wrapper[kind].launches = 0
        with FlopCounterMode(display=False) as fc:
            fn(*args)
        sync()
        n_real = wrapper[kind].launches
        k = ana["kernels"].get(kernel[kind], {"launches": [], "flops": []})
        n_dry = sum(k["launches"])
        if not n_dry == n_real == cfg.n_layers * d * m:
            fail(f"17 {kind}: the dry run counts {n_dry} {kernel[kind]} "
                 f"launches, the card ran {n_real}, expected "
                 f"{cfg.n_layers} x {d * m}")
        aten = sum(r["flops"] for r in ana["per_device"]) - sum(k["flops"])
        if aten != fc.get_total_flops():
            fail(f"17 {kind}: the dry run's aten FLOPs {aten} != "
                 f"FlopCounterMode's {fc.get_total_flops()} on the card")
        got = [r["memory"]["argument_bytes"] for r in ana["per_device"]]
        if got != want or ana["off_mesh_ops"]:
            fail(f"17 {kind}: argument bytes a device {got}, the ranks' "
                 f"held slices {want}; {ana['off_mesh_ops']} ops off the "
                 f"mesh")
        mem = ana["memory"]
        print(f"[dryrun] {card}: {cfg.name} full() {kind} {sz[kind]} over a "
              f"({d}, {m}) mesh of meta devices, traced in {trace_s:.1f} s "
              f"({ana['ops']} aten ops): {n_dry} {kernel[kind]} launches "
              f"== the card's {n_real}; aten FLOPs {aten} == "
              f"FlopCounterMode's on the card; argument bytes a device "
              f"{got} == the ranks' held slices; per device (largest): "
              f"FLOPs {ana['flops']} (kernels {max(k['flops'])}), traffic "
              f"{ana['traffic_bytes']} B, copied {ana['collective_bytes']}"
              f" B, temp {mem['temp_bytes']} B, output "
              f"{mem['output_bytes']} B")
        del fn, args
        torch.cuda.empty_cache()

    ana, trace_s = dry("prefill", 1, 1)
    fn, args, _ = real("prefill", 1, 1)
    fn(*args)                                   # warm-up: workspaces
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn(*args)
    sync()
    rise = torch.cuda.max_memory_allocated() - base
    mem = ana["memory"]
    gap = abs(mem["peak_bytes"] - rise) / rise
    print(f"[dryrun] {card}: {cfg.name} full() prefill {sz['prefill']} on "
          f"(1, 1): dry run temp {mem['temp_bytes']} B + output "
          f"{mem['output_bytes']} B, peak {mem['peak_bytes']} B beside the "
          f"card's max_memory_allocated rise {rise} B over the step "
          f"({gap:.4f} of it; limit {sz['mem_rtol']})")
    if not gap <= sz["mem_rtol"]:
        fail(f"17: the dry run's prefill peak {mem['peak_bytes']} B is "
             f"{gap:.4f} of the card's rise {rise} B away (limit "
             f"{sz['mem_rtol']})")
    del params, fn, args, out
    torch.cuda.empty_cache()
    print(f"[dryrun] phase 17 took {time.perf_counter() - t_phase:.1f} s")


def fp16_bli(kernels, dcn) -> None:
    """Phase 18a's #6: the BLI kernel on phase 2's serving-shape planes
    (one image, a serving step's four) rounded to float16, held within
    F16_RTOL of its plain version, rerun bitwise and timed
    (``dcn["bli"]``: phase 2's ``bli_record`` and its operands); then
    ``ops.bli_pallas`` on the first DCN layer's float16 plane, its
    launches counted, within F16_RTOL of the same call on the plane
    widened to float32 (the sum is float32 in both; one rounding)."""
    import torch

    from repro_torch.kernels import dcn_bli as kb
    from repro_torch.kernels import ops

    record, a6, a6x4, plane, coords = dcn["bli"]
    f16 = torch.float16
    entries = kernels["bli_tile_matmul"].setdefault("fp16", {})
    entries["fp16 N=1"] = record("serving shape", (a6[0].to(f16), *a6[1:]))
    entries["fp16 N=4"] = record("serving step", (a6x4[0].to(f16),
                                                  *a6x4[1:]))
    x16 = plane.to(f16)
    kb.bli_tile_matmul.launches = 0
    got = ops.bli_pallas(x16, coords)
    n = kb.bli_tile_matmul.launches
    want = ops.bli_pallas(x16.float(), coords)
    if got.dtype != f16 or n != 1:
        fail(f"bli_pallas on a float16 plane: {got.dtype}, {n} launches")
    err, sc = hold("bli_pallas float16 vs the widened plane", got.float(),
                   want, F16_RTOL)
    entries["fp16 N=1"]["launches"] = n
    print(f"[lm-fp16] bli_pallas on the float16 {tuple(plane.shape)} plane:"
          f" {n} bli_tile_matmul launch, max|d| vs the float32 plane "
          f"{err:.3e} (limit {F16_RTOL:.4g}*{sc:.3f})")


def fp16_lm_phase(card, kernels, reset_counts, peak_bw) -> None:
    """Phase 18c: Qwen3-1.7B ``full()`` in float16 (3.4 GB from the seed):
    a float32 run of the same float16 weights gives the model's own
    float16 error (and shows whether float16 overflows: finite logits,
    their largest magnitude printed); phase 6's prefill through #7's
    16-bit kernel (28 launches, all float16) against the float16 ``_sdpa``
    path within max(noise_factor x eps, F16_RTOL); phase 7's requests
    through ``DecodeEngine(cache_dtype=float16)``, every #8 launch on a
    float16 cache through the split body and on the engine's own cache
    tensors, tokens held to the prefill argmax; one float16 layer over a
    float32 cache (``F16_SIZES["layer"]``). eps is read with cuBLAS's
    ``allow_fp16_reduced_precision_reduction`` off (float32 accumulation,
    scoped to one ``_sdpa`` run here; the port sets no such flag), and the
    path at the flag's default is held to the resulting limit too."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import layers, lm
    from repro_torch.models.params import param_bytes, param_count
    from repro_torch.models.transformer import layer_slices

    dev, sync, f16 = torch.device("cuda"), torch.cuda.synchronize, \
        torch.float16
    sz, lsz = F16_SIZES, LM_SIZES
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(lsz["arch"])
    cfg_flash = dataclasses.replace(cfg, use_flash=True)
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, SEED, device=dev, dtype=f16)
    sync()
    if {t.dtype for t in tree_leaves(params)} != {f16}:
        fail(f"{cfg.name}: float16 init gave leaves of "
             f"{ {t.dtype for t in tree_leaves(params)} }")
    flag = torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction
    print(f"[lm-fp16] {cfg.name} full() in float16: {param_count(params):,} "
          f"params = {param_bytes(params) / 1e9:.2f} GB from seed {SEED} in "
          f"{time.perf_counter() - t0:.1f} s; torch.backends.cuda.matmul."
          f"allow_fp16_reduced_precision_reduction = {flag}")
    prng = np.random.default_rng(SEED + 6)
    toks = torch.as_tensor(prng.integers(
        0, cfg.vocab, size=(lsz["prefill_batch"], lsz["prefill_len"]))
        .astype(np.int32), device=dev)
    t0 = time.perf_counter()
    p32 = tree_map(lambda t: t.float(), params)
    ref32 = lm.lm_prefill(p32, cfg_flash, {"tokens": toks})
    sync()
    del p32
    torch.cuda.empty_cache()
    print(f"[lm-fp16] float32 run of the same weights ({tuple(toks.shape)}) "
          f"in {time.perf_counter() - t0:.1f} s: max|logits| "
          f"{float(ref32.abs().max()):.4f}")
    limits = {}

    def eps_of(logits16):
        return float((logits16.float() - ref32).abs().max()
                     / ref32.abs().max())

    def prefill_limit(sdpa16):
        """The prefill limit from eps read with cuBLAS's reduced-precision
        float16 reductions off (float32 accumulation, as JAX's products):
        the ``_sdpa`` path is run once more with the flag off, scoped to
        that run and restored. The path at the flag's default must stay
        within the limit of the float32 run: otherwise the reductions pull
        the port away from float32 accumulation."""
        if not torch.isfinite(sdpa16.float()).all():
            fail(f"{cfg.name} float16 _sdpa prefill: logits not finite "
                 f"(float16 overflow)")
        matmul = torch.backends.cuda.matmul
        matmul.allow_fp16_reduced_precision_reduction = False
        try:
            sdpa_off = lm.lm_prefill(params, cfg, {"tokens": toks})
            sync()
        finally:
            matmul.allow_fp16_reduced_precision_reduction = flag
        eps, eps_on = eps_of(sdpa_off), eps_of(sdpa16)
        moved = float((sdpa16.float() - sdpa_off.float()).abs().max()
                      / ref32.abs().max())
        rt = max(sz["noise_factor"] * eps, F16_RTOL)
        print(f"[lm-fp16] float16 _sdpa path prefill: finite, max|logits| "
              f"{float(sdpa16.float().abs().max()):.4f}; from the float32 "
              f"run, of max|ref|: {eps:.4e} with "
              f"allow_fp16_reduced_precision_reduction = False, {eps_on:.4e}"
              f" with {flag} (the default, the port's); the flag moves the "
              f"logits by {moved:.4e}; prefill limit max("
              f"{sz['noise_factor']} x {eps:.4e}, 2^-10) = {rt:.4e}")
        if eps_on > rt:
            fail(f"{cfg.name} float16 prefill with allow_fp16_reduced_"
                 f"precision_reduction = {flag}: {eps_on:.4e} of max|ref| "
                 f"from the float32 run, past the limit {rt:.4e} of float32 "
                 f"accumulation")
        limits["prefill"] = rt
        return rt

    fa.flash_attention.dtypes, fa.flash_attention.bodies = {}, {}
    n7, held7, wall, _ = prefill_through_flash(
        card, "lm-fp16", params, cfg, toks, reset_counts,
        logit_rtol=prefill_limit, attn_rtol=F16_RTOL)
    n_attn = attn_layers(cfg)
    if (n7 != n_attn or fa.flash_attention.dtypes != {"float16": n7}
            or fa.flash_attention.bodies != {"16bit": n7}):
        fail(f"the float16 prefill launched flash_attention "
             f"{fa.flash_attention.dtypes} {fa.flash_attention.bodies}, "
             f"expected {n_attn} float16 launches of the 16-bit body")
    del held7
    print(f"[lm-fp16] {card}: float16 prefill {tuple(toks.shape)}: {n7} #7 "
          f"launches, by type {fa.flash_attention.dtypes}, by body "
          f"{fa.flash_attention.bodies}; {wall * 1e3:.1f} ms = "
          f"{toks.numel() / wall:.0f} prefill tokens/s")
    kernels["flash_attention"]["fp16"]["fp16 Qwen3-1.7B prefill"][
        "launches"] = n7
    del ref32
    torch.cuda.empty_cache()

    fd.flash_decode.dtypes, fd.flash_decode.bodies = {}, {}
    timed8, n8, eng, step_s, _ = serve_through_decode(
        card, "lm-fp16", params, cfg, reset_counts, cache_dtype=f16,
        attn_rtol=F16_RTOL, gap_rtol=limits["prefill"])
    if set(fd.flash_decode.dtypes) != {"float16/float16"} or \
            set(fd.flash_decode.bodies) != {"split"}:
        fail(f"float16 serving launched flash_decode "
             f"{fd.flash_decode.dtypes} {fd.flash_decode.bodies}, expected "
             f"a float16 q over a float16 cache through the split body")
    kernels["flash_decode"]["fp16"][f"fp16 {cfg.name} decode, serving "
                                    f"step"] = dict(timed8, launches=n8)
    print(f"[lm-fp16] {card}: float16 serving: {n8} #8 launches, by type "
          f"{fd.flash_decode.dtypes}, by body {fd.flash_decode.bodies}; "
          f"step p50 {np.percentile(step_s, 50) * 1e3:.2f} ms")
    del eng
    torch.cuda.empty_cache()

    # One float16 layer over a float32 cache whose values lie within 0.2
    # float16 ulp of float16 numbers: #8 rounds them back (round_kv), so
    # the layer gives the float16 cache's result; the unrounded read moves
    # it.
    b, s, pos = sz["layer"]
    acfg = cfg.attn_cfg(cfg.pattern[0])
    p0 = layer_slices(params["layers"]["stack"]["b0"])[0]["attn"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    x = torch.randn((b, 1, cfg.d_model), generator=gen, device=dev).to(f16)
    pos = torch.tensor(pos, device=dev)
    half, wide = {}, {}
    for name in ("k", "v"):
        kh = torch.randn((b, s, acfg.n_kv_heads, acfg.head_dim),
                         generator=gen, device=dev).to(f16)
        ulp = torch.ldexp(torch.ones_like(kh, dtype=torch.float32),
                          torch.floor(torch.log2(kh.float().abs())).int()
                          - 10)
        nudge = 0.2 * ulp * (2 * torch.rand(kh.shape, generator=gen,
                                            device=dev).round() - 1)
        half[name] = kh
        wide[name] = kh.float() + torch.where(kh == 0, 0, nudge)
        if not torch.equal(wide[name].to(f16), kh):
            fail("the nudged float32 cache does not round to its float16 "
                 "values")
    fd.flash_decode.dtypes = {}
    want, _ = layers.attention_decode(p0, acfg, x, dict(half), pos)
    got, _ = layers.attention_decode(p0, acfg, x, dict(wide), pos)
    if fd.flash_decode.dtypes != {"float16/float16": 1,
                                  "float16/float32": 1}:
        fail(f"the float16 layer launched #8 {fd.flash_decode.dtypes}")
    rounds = layers._rounds_cache
    layers._rounds_cache = lambda x, c: None
    try:
        unrounded, _ = layers.attention_decode(p0, acfg, x, dict(wide), pos)
    finally:
        layers._rounds_cache = rounds
    err, sc = hold("a float16 layer over a nudged float32 cache vs the "
                   "float16 cache", got.float(), want.float(), 1e-5)
    moved, _ = rel_err(unrounded.float(), want.float())
    if not moved > 1e-5 * sc:
        fail(f"the unrounded read moved the layer by only {moved}: the "
             f"check cannot see the rounding")
    print(f"[lm-fp16] {cfg.name} layer 0 in float16 over a float32 cache "
          f"within 0.2 float16 ulp of float16 values (B={b} S={s} pos "
          f"{pos.tolist()}): #8 round_kv=float16, max|d| vs the float16 "
          f"cache {err:.3e} (limit 1e-5*{sc:.3f}); without the rounding "
          f"{moved:.3e}")
    print(f"[lm-fp16] 18c max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del params
    torch.cuda.empty_cache()


def general_bodies_phase(card, kernels, launches) -> None:
    """Phase 18d: the general bodies of #7 and #8 (csrc/attention_any.cu,
    and csrc/attention_wide.cu for the head dims past its shared memory)
    at ``F16_SIZES``' shapes in float32, bf16 and float16: each call held
    against its plain version (ATTN_RTOL / BF16_RTOL / F16_RTOL), the body
    each took printed beside ``attention_body`` / ``decode_body``'s
    answer and the general route's plan path; one view off a 16-byte boundary for each; a float32 q over a
    bf16 and a float16 cache (ATTN_RTOL); a bf16 cache of B x Hkv = 65,536
    at a few rows. The two timed shapes give the JSON entries
    ``flash_attention_any`` / ``flash_decode_any`` (float16), each with its
    float32 and bf16 times under ``shapes`` (each beside its bound, SDPA in
    the same type and the plain version); their launches are the general
    bodies' in this phase."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    dev, sz = torch.device("cuda"), F16_SIZES
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    rng = np.random.default_rng(SEED + 20)
    rtols = {torch.float32: ATTN_RTOL, torch.bfloat16: BF16_RTOL,
             torch.float16: F16_RTOL}

    def randn(dtype, *shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def off16(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        moved = buf[1:].view(t.shape)
        moved.copy_(t)
        return moved

    # The timed shapes' rate units by operand type: 16-bit products at the
    # dense bf16 / fp16 rate, float32 ones in 3xTF32.
    units = {torch.float32: "3xtf32", torch.bfloat16: "bf16",
             torch.float16: "fp16"}
    timed = {"flash_attention_any": {}, "flash_decode_any": {}}
    # Each decode shape's lengths, drawn once so that the three types (and
    # `tools/kernel_ab.py --only any`) see the same visible keys.
    lengths = {c[0]: torch.as_tensor(
        np.random.default_rng(SEED + 20).integers(0, c[2] + 1, size=c[1]),
        dtype=torch.int32, device=dev) for c in sz["any_decode"]}

    def path(mode, d, rows, pairs, q, kv):
        """The general route's plan path: the tensor-core body's, or the
        wide head dims' (csrc/attention_wide.cu)."""
        return fa.general_plan(mode, d, rows, pairs, q.dtype, kv.dtype,
                               splits=1)["path"]

    t_phase = time.perf_counter()
    for fn in (fa.flash_attention, fd.flash_decode):
        fn.launches, fn.bodies = 0, {}
    for dtype, rtol in rtols.items():
        short = str(dtype).removeprefix("torch.")
        for name, b, sq, skv, hq, hkv, d, opts in sz["any_flash"]:
            q, k, v = (randn(dtype, *sh) for sh in (
                (b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
            want = fa.flash_attention_plain(q, k, v, scale=d ** -0.5,
                                            **opts)
            cases = [("", (q, k, v), True)]
            if name == sz["any_flash"][0][0]:
                cases.append((", q and v off 16 B", (off16(q), k, off16(v)),
                              False))
            for note, args, aligned in cases:
                before = dict(fa.flash_attention.bodies)
                got = fa.flash_attention(*args, **opts)
                body = fa.attention_body(d, dtype, aligned)
                took = {k_: n - before.get(k_, 0) for k_, n in
                        fa.flash_attention.bodies.items()
                        if n != before.get(k_, 0)}
                if took != {body: 1} or got.dtype != dtype:
                    fail(f"#7 {short} {name}{note}: bodies {took}, "
                         f"attention_body says {body}, {got.dtype}")
                err, sc = hold(f"#7 {short} {name}{note}", got.float(),
                               want.float(), rtol)
                via = (f" ({path(0, d, sq, b * hq, q, k)} path)"
                       if body == "general" else "")
                print(f"[any] #7 {short} {name}{note} (B={b} Sq={sq} "
                      f"Skv={skv} Hq={hq} Hkv={hkv} D={d} {opts or 'causal'})"
                      f": the {body} body{via}, max|d| {err:.3e} (limit "
                      f"{rtol:.4g}*{sc:.3f})")
                if name == sz["timed_flash"] and aligned:
                    live = live_pairs(sq, skv, opts.get("causal", True),
                                      opts.get("window"))
                    qt, kt, vt = (t.transpose(1, 2).contiguous()
                                  for t in (q, k, v))
                    lib = sdpa_yardstick(qt, kt, vt,
                                         is_causal=opts.get("causal", True))
                    timed["flash_attention_any"][short] = dict(
                        body=body, max_abs_err=err,
                        ms=cuda_time_ms(
                            lambda: fa.flash_attention(q, k, v, **opts), 5),
                        plain_ms=cuda_time_ms(lambda: fa.flash_attention_plain(
                            q, k, v, scale=d ** -0.5, **opts), 2, warmup=1),
                        library_ms=cuda_time_ms(lib, 5),
                        ops={units[dtype]: 4 * b * hq * live * d},
                        bytes=q.element_size() * (2 * q.numel() + k.numel()
                                                  + v.numel()),
                        shape=f"{short} {name} B={b} S={sq} Hq={hq} "
                              f"Hkv={hkv} D={d}, the general body")
                    del qt, kt, vt
            del q, k, v, want
        for name, b, s, hq, hkv, d, opts in sz["any_decode"]:
            q = randn(dtype, b, hq, d)
            kc, vc = randn(dtype, b, s, hkv, d), randn(dtype, b, s, hkv, d)
            lens = lengths[name]
            want = fd.flash_decode_plain(q, kc, vc, lens, scale=d ** -0.5,
                                         **opts)
            cases = [("", (q, kc, vc), True)]
            if name == sz["any_decode"][0][0]:
                cases.append((", q and k off 16 B", (off16(q), off16(kc),
                                                     vc), False))
            for note, args, aligned in cases:
                before = dict(fd.flash_decode.bodies)
                got = fd.flash_decode(*args, lens, **opts)
                body = fd.decode_body(d, hq // hkv, dtype, aligned, b * hkv)
                took = {k_: n - before.get(k_, 0) for k_, n in
                        fd.flash_decode.bodies.items()
                        if n != before.get(k_, 0)}
                if took != {body: 1} or got.dtype != dtype:
                    fail(f"#8 {short} {name}{note}: bodies {took}, "
                         f"decode_body says {body}, {got.dtype}")
                err, sc = hold(f"#8 {short} {name}{note}", got.float(),
                               want.float(), rtol)
                via = (f" ({path(1, d, hq // hkv, b * hkv, q, kc)} path)"
                       if body == "general" else "")
                print(f"[any] #8 {short} {name}{note} (B={b} S={s} Hq={hq} "
                      f"Hkv={hkv} D={d} {opts}): the {body} body{via}, max|d| "
                      f"{err:.3e} (limit {rtol:.4g}*{sc:.3f})")
                if name == sz["timed_decode"] and aligned:
                    vis = int(lens.clamp(max=s).sum())
                    ki = torch.arange(s, device=dev)[None, :]
                    mask = (ki < lens[:, None].long())[:, None, None, :]
                    kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (kc, vc))
                    lib = sdpa_yardstick(q[:, :, None], kt, vt,
                                         attn_mask=mask, scale=d ** -0.5)
                    size = q.element_size()
                    timed["flash_decode_any"][short] = dict(
                        body=body, max_abs_err=err,
                        ms=cuda_time_ms(
                            lambda: fd.flash_decode(q, kc, vc, lens, **opts),
                            20),
                        plain_ms=cuda_time_ms(lambda: fd.flash_decode_plain(
                            q, kc, vc, lens, scale=d ** -0.5, **opts), 5),
                        library_ms=cuda_time_ms(lib, 20),
                        ops={units[dtype]: 4 * vis * hq * d},
                        bytes=size * (2 * vis * hkv * d + 2 * q.numel())
                        + 4 * b,
                        shape=f"{short} cache, {short} q, {name} B={b} "
                              f"S={s} Hq={hq} Hkv={hkv} D={d}, lengths "
                              f"{lens.tolist()}, {vis} visible keys, the "
                              f"general body")
                    del kt, vt, mask
            del q, kc, vc, want
        torch.cuda.empty_cache()
    # A float32 q over a 16-bit cache: the float32 function of the widened
    # cache (exact), within ATTN_RTOL.
    name, b, s, hq, hkv, d, opts = next(
        c for c in sz["any_decode"] if c[0] == sz["timed_decode"])
    q = randn(torch.float32, b, hq, d)
    lens = lengths[name]
    for cache in (torch.bfloat16, torch.float16):
        kc, vc = randn(cache, b, s, hkv, d), randn(cache, b, s, hkv, d)
        before = fd.flash_decode.bodies.get("general", 0)
        got = fd.flash_decode(q, kc, vc, lens, **opts)
        if (fd.flash_decode.bodies.get("general", 0) != before + 1
                or got.dtype != torch.float32):
            fail(f"#8 float32 q over a {cache} cache: bodies "
                 f"{fd.flash_decode.bodies}, {got.dtype}")
        err, sc = hold(f"#8 float32 q over a {cache} cache", got,
                       fd.flash_decode_plain(q, kc, vc, lens, scale=d ** -0.5,
                                             **opts), ATTN_RTOL)
        print(f"[any] #8 float32 q over a {str(cache)[6:]} cache, {name} "
              f"(B={b} S={s} Hq={hq} Hkv={hkv} D={d}): the general body, "
              f"max|d| {err:.3e} (limit {ATTN_RTOL:.4g}*{sc:.3f})")
        del kc, vc
    del q
    for key, source in (("flash_attention_any", "flash_attention.py:27"),
                        ("flash_decode_any", "flash_decode.py:28")):
        by_type = timed[key]
        kernels[key] = dict(route="cuda",
                            source="src/repro_torch/csrc/attention_any.cu",
                            replaces=f"src/repro/kernels/{source}",
                            **by_type.pop("float16"), shapes=by_type)
    b, hkv, hq, s, d = sz["many_pairs"]
    q = randn(torch.bfloat16, b, hq, d)
    kc, vc = (randn(torch.bfloat16, b, s, hkv, d) for _ in range(2))
    lens = torch.as_tensor(rng.integers(0, s + 1, size=b), dtype=torch.int32,
                           device=dev)
    before = dict(fd.flash_decode.bodies)
    got = fd.flash_decode(q, kc, vc, lens)
    if fd.flash_decode.bodies.get("general", 0) != before.get("general",
                                                              0) + 1:
        fail(f"#8 over a bf16 cache of B x Hkv = {b * hkv}: bodies "
             f"{fd.flash_decode.bodies}, expected the general body")
    err, sc = hold(f"#8 bf16 B x Hkv = {b * hkv}", got.float(),
                   fd.flash_decode_plain(q, kc, vc, lens,
                                         scale=d ** -0.5).float(), BF16_RTOL)
    print(f"[any] #8 over a bf16 cache of B x Hkv = {b * hkv} (B={b} S={s} "
          f"Hq={hq} Hkv={hkv} D={d}): the general body, max|d| {err:.3e} "
          f"(limit {BF16_RTOL:.4g}*{sc:.3f})")
    launches["flash_attention_any"] = fa.flash_attention.bodies.get(
        "general", 0)
    launches["flash_decode_any"] = fd.flash_decode.bodies.get("general", 0)
    print(f"[any] {card}: phase 18d took {time.perf_counter() - t_phase:.1f}"
          f" s; #7 launches by body {fa.flash_attention.bodies}, #8 "
          f"{fd.flash_decode.bodies}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this run "
              "needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import scheduler as sched_mod
    from repro_torch.core.deform import (bilinear_sample, conv2d,
                                         offsets_to_coords,
                                         randomize_offset_conv)
    from repro_torch.core.simulator import simulate_network
    from repro_torch.core.tiles import TileGrid, compose_tdt_chain
    from repro_torch.kernels import _build
    from repro_torch.kernels import dcn_bli as kb
    from repro_torch.kernels import dcn_fused as kf
    from repro_torch.kernels import dcn_schedule as ks
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import DeviceMesh, make_host_mesh
    from repro_torch.models.dcn_models import (DcnNetConfig, apply_head,
                                               dcn_net_apply, init_dcn_net)
    from repro_torch.runtime import fused_exec as fx
    from repro_torch.runtime.cache import ScheduleCache
    from repro_torch.runtime.graph import (DeformNode, FusedGroup, PoolNode,
                                           UpsampleNode, build_graph,
                                           partition_graph_cached)
    from repro_torch.serving import DcnServingEngine, RequestFailedError
    from repro_torch.testing import FaultError, FaultInjector
    from repro_torch.tuning import PlanCache

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    print("settings: cuda.matmul.allow_tf32=False cudnn.allow_tf32=False "
          "cudnn.deterministic=True (TF32 would move the floors of the "
          "sampling coordinates, and with them the schedules)")
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    peak_fp32, peak_tf32, peak_bw = next(
        (v for k, v in PEAKS.items() if k in kind), PEAK_SXM)
    # Operation rates by the units a kernel's work runs on: FP32 on the
    # CUDA cores; the 3xTF32 contraction of #1 / #4 / #5 at a third of the
    # dense TF32 tensor-core rate (three TF32 products per FP32 product).
    # Their contraction on bf16 weights at a third of the dense bf16 rate:
    # the float32 patch splits exactly into three bf16 pieces (8 + 8 + 8
    # significant bits), and each piece times a bf16 weight is exact in
    # float32, so three bf16 products give the FP32-accurate product (the
    # kernels' own 2xTF32 runs at 495 / 2, slower). Their contraction on
    # float16 weights at half the dense TF32 rate: a float16 weight (11
    # significant bits) is exact in TF32, so its residual is zero and two
    # TF32 products (patch high and low part times the weight) give the
    # FP32-accurate product. Dense bf16 on the tensor cores is twice dense
    # TF32 on every Hopper part (SXM 989, PCIe 756, NVL 835 TFLOP/s).
    rates = {"fp32": (peak_fp32, f"FP32 {peak_fp32 / 1e12:g} TFLOP/s"),
             "3xtf32": (peak_tf32 / 3, f"3xTF32 {peak_tf32 / 3e12:.4g} "
                        f"TFLOP/s (TF32 {peak_tf32 / 1e12:g} / 3)"),
             "2xtf32": (peak_tf32 / 2, f"2xTF32 {peak_tf32 / 2e12:.4g} "
                        f"TFLOP/s (TF32 {peak_tf32 / 1e12:g} / 2)"),
             "3xbf16": (2 * peak_tf32 / 3, f"3xbf16 "
                        f"{2 * peak_tf32 / 3e12:.4g} TFLOP/s (bf16 dense "
                        f"{2 * peak_tf32 / 1e12:g} / 3)"),
             "bf16": (2 * peak_tf32, f"bf16 dense {2 * peak_tf32 / 1e12:g} "
                      f"TFLOP/s"),
             "fp16": (2 * peak_tf32, f"fp16 dense {2 * peak_tf32 / 1e12:g} "
                      f"TFLOP/s")}
    print(f"card: {card}; peaks used for bounds: {peak_fp32 / 1e12:g} "
          f"TFLOP/s fp32, {peak_tf32 / 1e12:g} TFLOP/s tf32 dense, "
          f"{peak_bw / 1e12:g} TB/s")

    def bound_of(ops: dict, nbytes: int) -> dict:
        """The least time of a call: the larger of its bytes over the
        memory rate and, over the units it runs on, its operations over
        their rate; with what bounds it and at which rate."""
        unit = max(ops, key=lambda u: ops[u] / rates[u][0])
        ops_ms = ops[unit] / rates[unit][0] * 1e3
        bytes_ms = nbytes / peak_bw * 1e3
        if ops_ms > bytes_ms:
            return dict(bound_ms=ops_ms, bound_by="operations",
                        bound_rate=rates[unit][1])
        return dict(bound_ms=bytes_ms, bound_by="bytes",
                    bound_rate=f"memory {peak_bw / 1e12:g} TB/s")
    wrappers = {"dcn_fused_batch": kf.dcn_fused_batch,
                "tdt_from_coords_device": ks.tdt_from_coords_device,
                "greedy_schedule_arrays": ks.greedy_schedule_arrays,
                "schedule_group_batch": ks.schedule_group_batch,
                "dcn_fused_schedule": kf.dcn_fused_schedule,
                "dcn_fused_tile": kf.dcn_fused_tile,
                "bli_tile_matmul": kb.bli_tile_matmul,
                "flash_attention": fa.flash_attention,
                "flash_decode": fd.flash_decode}
    launches = {}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
        for fn in (fa.flash_attention, fd.flash_decode, kf.dcn_fused_batch,
                   kf.dcn_fused_schedule, kf.dcn_fused_tile):
            fn.dtypes = {}
        for fn in (fa.flash_attention, fd.flash_decode):
            fn.bodies = {}

    def read_counts(*names, into=launches):
        got = {n: wrappers[n].launches for n in names}
        for name, n in got.items():
            if n <= 0:
                fail(f"{name} was not launched on its path")
        into.update(got)
        return got

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.load()

    def empty_launch():
        _build.check(lib.empty_launch(
            torch.cuda.current_stream().cuda_stream), "empty launch")
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    # -- model ---------------------------------------------------------------
    cfg = DcnNetConfig("vgg19", n_deform=3, variant="dcn2", img_size=224,
                       width_mult=1.0, num_classes=1000)
    params = init_dcn_net(SEED, cfg, device=dev)
    gen = torch.Generator().manual_seed(SEED + 1)
    params["convs"] = [
        randomize_offset_conv(p, gen, 2.0 / p.w.shape[2])
        if hasattr(p, "w_off") else p for p in params["convs"]]
    graph = build_graph(cfg)
    rng = np.random.default_rng(SEED + 2)
    images = rng.normal(size=(16, 224, 224, 3)).astype(np.float32)

    def dense_logits(x_np):
        xr = torch.as_tensor(x_np, device=dev)
        return apply_head(params, cfg, fx.run_graph_dense(
            params["convs"], graph, xr)).cpu().numpy()

    def check_logits(what, out, ref):
        if out.shape != ref.shape or not np.isfinite(out).all():
            fail(f"{what}: logits {out.shape} not finite/shaped like "
                 f"{ref.shape}")
        d, sc = float(np.abs(out - ref).max()), float(np.abs(ref).max())
        if not d <= LOGIT_RTOL * sc:
            fail(f"{what}: max|logit - ref| = {d} > {LOGIT_RTOL} * {sc}")
        return d / sc

    def check_sim(what, traces):
        for tr in traces:
            sim = simulate_network(fx.network_sim_specs(tr),
                                   boundary_bytes=tr.boundary_bytes)
            if sim.total_dram_bytes != tr.total_dram_bytes:
                fail(f"{what}: trace DRAM {tr.total_dram_bytes} != "
                     f"simulator {sim.total_dram_bytes}")

    def first_dcn_plane(x_np):
        """The first DCN layer's input planes (dense chain), sampling
        coordinates, params and node for the images ``x_np``."""
        plane = torch.as_tensor(x_np, device=dev)
        for node in graph.nodes:
            if isinstance(node, DeformNode):
                p = params["convs"][node.param_idx]
                off = conv2d(plane, p.w_off, p.b_off)
                return (plane.contiguous(),
                        offsets_to_coords(off, 3, cfg.variant), p, node, off)
            if isinstance(node, (PoolNode, UpsampleNode)):
                plane = fx.apply_boundary_batch(plane, node)
            else:
                plane = fx._advance_dense_batch(
                    plane, node, params["convs"][node.param_idx], None)
        fail("the model has no DCN layer")

    # The first DCN layer's input plane (image 0) and params; and the
    # planes of a serving step's four images (for #6 at N = 4).
    dcn_in, dcn_coords, p_dcn, node, off = first_dcn_plane(images[:1])
    dcn_in4, dcn_coords4 = first_dcn_plane(images[:N_BATCH])[:2]
    print(f"[model] VGG19-{cfg.n_deform} DCN-II {cfg.img_size}x"
          f"{cfg.img_size} width {cfg.width_mult}, {cfg.num_classes} "
          f"classes; first DCN layer {node.h}x{node.w}x{node.c_in}: mean "
          f"|offset| = {float(off.abs().mean()):.4f} px")

    # -- phase 2: kernels against their plain versions -----------------------
    captured = {k: [] for k in ("fused", "group", "tdt", "greedy", "sched",
                                "plane_tile", "bli")}
    with contextlib.ExitStack() as stack:
        stack.enter_context(recording(fx, "dcn_fused_batch",
                                      captured["fused"]))
        stack.enter_context(recording(fx, "schedule_group_batch",
                                      captured["group"]))
        xb = torch.as_tensor(images[:N_BATCH], device=dev)
        fx.run_graph(params["convs"], graph, xb,
                     config=fx.GraphConfig(tile=8, schedule_backend="device"),
                     schedule_cache=ScheduleCache())
    with contextlib.ExitStack() as stack:
        stack.enter_context(recording(fx, "dcn_fused_schedule",
                                      captured["sched"]))
        stack.enter_context(recording(fx, "tdt_from_coords_device",
                                      captured["tdt"]))
        stack.enter_context(recording(sched_mod, "greedy_schedule_arrays",
                                      captured["greedy"]))
        fx.run_graph(params["convs"], graph, xb[:1],
                     config=fx.GraphConfig(tile=8, dispatch="batched",
                                           schedule_backend="device"),
                     schedule_cache=ScheduleCache())
    with recording(ops, "dcn_fused_tile", captured["plane_tile"]):
        ops.deformable_conv2d_pallas(dcn_in, p_dcn)
    with recording(ops, "bli_tile_matmul", captured["bli"]):
        ops.bli_pallas(dcn_in, dcn_coords)
        ops.bli_pallas(dcn_in4, dcn_coords4)
    torch.cuda.synchronize()
    if not all(captured.values()):
        fail(f"prepass did not reach every kernel: "
             f"{ {k: len(v) for k, v in captured.items()} }")

    def fused_ops(live_px, kk, c_in, c_out, contraction):
        """Operations of a fused call by unit: the BLI (8 per tap and
        channel) on FP32, the contraction on ``contraction``'s units."""
        bli, mm = 8 * live_px * kk * c_in, 2 * live_px * kk * c_in * c_out
        if contraction == "fp32":
            return dict(fp32=bli + mm)
        return {"fp32": bli, contraction: mm}

    def nbytes_of(tensors, out_numel):
        return sum(t.numel() * t.element_size() for t in tensors) \
            + out_numel * 4

    def contraction(rows, w):
        """The library yardstick of a fused kernel: torch.matmul of the
        (rows, KK*C) patch with the (KK*C, O) weights, in w's dtype."""
        kk, c_in, c_out = w.shape
        patch = torch.randn(rows, kk * c_in, device=dev, dtype=w.dtype)
        w2 = w.reshape(kk * c_in, c_out)
        return cuda_time_ms(lambda: torch.matmul(patch, w2), 50)

    def hold_fused(name, calls, fn, plain, rtol):
        """Every captured call of ``fn`` against ``plain`` (which takes the
        call's tensors and, for #1, its ``t_in``); returns the first
        call's error. For the split-C kernels (#1, #4, #5) each call's
        grid and ``n_split`` are printed, and its default split is also
        held against ``n_split = 1`` within ``SPLIT_RTOL * max|ref|``."""
        errs = []
        for i, (a, k) in enumerate(calls):
            got = fn(*a, **k)
            d, sc = rel_err(got, plain(*a, **{n: v for n, v in k.items()
                                              if n == "t_in"}))
            torch.cuda.synchronize()
            if not d <= rtol * sc:
                fail(f"{name}: max|d|={d} > {rtol}*{sc}")
            errs.append(d)
            if not hasattr(fn, "last_grid"):
                continue
            grid = fn.last_grid
            ds, _ = rel_err(got, fn(*a, **k, n_split=1))
            if not ds <= SPLIT_RTOL * sc:
                fail(f"{name}: n_split={grid[3]} vs 1: max|d|={ds} > "
                     f"{SPLIT_RTOL}*{sc}")
            print(f"[kernels] {name} call {i}: grid (rows, pixel blocks, "
                  f"O blocks, n_split) = {grid}, {math.prod(grid)} blocks; "
                  f"max|d| vs plain {d:.3e} (limit {rtol}*{sc:.3f}), "
                  f"n_split={grid[3]} vs 1 {ds:.3e} (limit "
                  f"{SPLIT_RTOL}*{sc:.3f})")
        return errs[0]

    kernels = {}
    # (1) batch-fused BLI(+)conv, first DCN segment of the batch.
    a, k = captured["fused"][0]
    x_t, row, dep, cnt, idx, coeff, w, b = a
    err = hold_fused("dcn_fused_batch", captured["fused"],
                     kf.dcn_fused_batch, kf.dcn_fused_batch_plain,
                     FUSED_RTOL)
    g_rows, p_pix = row.shape[0], idx.shape[1]
    kk, c_in, c_out = w.shape
    live = int((cnt > 0).sum())
    a1, k1, live1 = a, k, live        # held again in bf16 in phase 14
    ms1 = cuda_time_ms(lambda: kf.dcn_fused_batch(*a, **k), 50)
    grid1 = kf.dcn_fused_batch.last_grid
    # The default grid against others: one that fits a single wave of two
    # blocks an SM, and a finer cut.
    by_split = {grid1[3]: ms1}
    for n in (4, 5, 8):
        if n not in by_split:
            by_split[n] = cuda_time_ms(
                lambda: kf.dcn_fused_batch(*a, **k, n_split=n), 50)
    print(f"[kernels] {card}: dcn_fused_batch by n_split (default "
          f"{grid1[3]}, grid {grid1}): " + ", ".join(
              f"{n} -> {math.prod(kf.fused_grid(g_rows, p_pix, c_out, n))} "
              f"blocks {t:.4f} ms" for n, t in sorted(by_split.items())))
    kernels["dcn_fused_batch"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_fused_split.cuh",
        replaces="src/repro/kernels/dcn_fused.py:249",
        max_abs_err=err, ms=ms1,
        plain_ms=cuda_time_ms(lambda: kf.dcn_fused_batch_plain(*a, **k), 5),
        library_ms=contraction(g_rows * p_pix, w),
        grid=list(grid1),
        ms_by_split={str(n): t for n, t in sorted(by_split.items())},
        ops=fused_ops(live * p_pix, kk, c_in, c_out, "3xtf32"),
        bytes=nbytes_of(a, g_rows * p_pix * c_out),
        shape=f"G={g_rows} P={p_pix} KK={kk} C={c_in} O={c_out} "
              f"k_pad={dep.shape[1]} live_rows={live}")

    # (2) TDT, every DCN layer image of the batched prepass; timed on the
    # first by its bare launch into a preallocated table, and through its
    # wrapper.
    for coords, gin, gout in (c for c, _ in captured["tdt"]):
        t_k = ks.tdt_from_coords_device(coords, gin, gout)
        t_p = ks.tdt_plain(coords, gin, gout)
        if not torch.equal(t_k, t_p):
            fail(f"tdt_from_coords_device differs from its plain version "
                 f"on {tuple(coords.shape)}")
    coords, gin, gout = captured["tdt"][0][0]
    tdt_out = torch.empty((gout.num_tiles, gin.num_tiles), dtype=torch.bool,
                          device=dev)
    kernels["tdt_from_coords_device"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_schedule.cu",
        replaces="src/repro/kernels/dcn_schedule.py:62", max_abs_err=0.0,
        ms=cuda_time_ms(ks.plan_tdt(coords, gin, gout, tdt_out).launch, 200),
        wrapper_ms=cuda_time_ms(
            lambda: ks.tdt_from_coords_device(coords, gin, gout), 200),
        plain_ms=cuda_time_ms(lambda: ks.tdt_plain(coords, gin, gout), 20),
        library_ms=None, ops=dict(fp32=0),
        bytes=coords.numel() * 4 + gout.num_tiles * gin.num_tiles,
        shape=f"coords {tuple(coords.shape)} -> "
              f"({gout.num_tiles}, {gin.num_tiles}), bare launch into a "
              f"preallocated table")

    def hold_schedule(what, im, comp, m, k_pad):
        """One image's schedule from the group kernel against the
        per-image chain (greedy_schedule_arrays, then
        dispatch_arrays_from_klass) and the numpy schedule_tiles on its
        composite ``comp``."""
        oid_k, klass_k, ovl_k = ks.greedy_schedule_arrays(
            torch.as_tensor(comp, device=dev), m)
        chain = ks.dispatch_arrays_from_klass(oid_k, klass_k, k_pad) \
            + (ovl_k.reshape(-1),)
        if not all(torch.equal(u, v) for u, v in zip(
                (im.oid, im.dep_tbl, im.dep_cnt, im.overlap), chain)):
            fail(f"{what}: the group kernel differs from the per-image "
                 f"greedy_schedule_arrays chain")
        host_s = sched_mod.schedule_tiles(comp, m)
        dev_s = sched_mod.DeviceSchedule(im.oid, im.dep_tbl, im.dep_cnt,
                                         im.overlap).to_host()
        if (dev_s.oid, dev_s.iid, dev_s.reuse_overlap) != \
                (host_s.oid, host_s.iid, host_s.reuse_overlap):
            fail(f"{what}: the group kernel differs from schedule_tiles")

    def hold_group(what, a, k):
        """One schedule_group_batch call against its plain version, every
        output of every listed image bit-exact, and each image's schedule
        against the per-image chain and schedule_tiles."""
        got = ks.schedule_group_batch(*a, **k)
        want = ks.schedule_group_batch_plain(*a, **k)
        for j in range(len(got.images)):
            im = got.image(j)
            if not all(torch.equal(u, v) for u, v in zip(
                    im.tensors(), want.image(j).tensors())):
                fail(f"{what}: schedule_group_batch differs from its plain "
                     f"version (image {got.images[j]})")
            comp = compose_tdt_chain([b.cpu().numpy() for b in im.tdt])
            hold_schedule(f"{what} image {got.images[j]}", im, comp, a[3],
                          a[4])
        return got

    # (3) greedy Algorithm 1 over every composite table of the batched
    # prepass, (784, 784) included: against the plain version and the
    # numpy host loop, and through the group kernel as a given table.
    for bt, m in (c for c, _ in captured["greedy"]):
        outs_k = ks.greedy_schedule_arrays(bt, m)
        outs_p = ks.greedy_plain(bt, m)
        if not all(torch.equal(u, v) for u, v in zip(outs_k, outs_p)):
            fail(f"greedy kernel differs from its plain version on "
                 f"{tuple(bt.shape)}")
        t = bt.shape[0]
        hold_group(f"schedule_group_batch on the table {tuple(bt.shape)}",
                   ([bt[None].contiguous()], [0], TileGrid(t, 1, 1, 1), m,
                    sched_mod.pow2_pad(t)), {})
    held3 = sorted({tuple(c[0].shape) for c, _ in captured["greedy"]})
    print(f"[kernels] greedy_schedule_arrays and schedule_group_batch held "
          f"bit-exact (plain version, per-image chain, schedule_tiles) on "
          f"the TDT shapes {held3}")
    kernels["greedy_schedule_arrays"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_schedule.cu",
        replaces="src/repro/kernels/dcn_schedule.py:142", max_abs_err=0.0,
        library_ms=None, ops=dict(fp32=0))

    # (2 + 3) the group kernel on every group of the 4-image batch-fused
    # prepass; timed at the serving shape (4 images, 14x14 -> (4, 4)).
    shapes = set()
    serving = None
    for a, k in captured["group"]:
        layers, imgs, grid_g = a[0], a[1], a[2]
        desc = (len(imgs), grid_g.num_tiles,
                tuple("conv" if isinstance(x, int) else tuple(x.shape[3:4])
                      for x in layers))
        shapes.add(desc)
        hold_group(f"schedule_group_batch {desc}", a, k)
        if serving is None and len(imgs) == N_BATCH and any(
                torch.is_tensor(x) for x in layers):
            serving = (a, k)
    if serving is None:
        fail("the batch-fused prepass made no 4-image DCN group call")
    print(f"[kernels] schedule_group_batch held bit-exact on all "
          f"{len(captured['group'])} group calls of the batch-fused "
          f"prepass (images, tiles, layers): {sorted(shapes, key=str)}")
    a_g, k_g = serving
    out_g = ks.schedule_group_batch(*a_g, **k_g)
    call_g = ks.plan_group(a_g[0], out_g, a_g[2], a_g[3])
    coords_g = [x for x in a_g[0] if torch.is_tensor(x)]
    kernels["schedule_group_batch"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_schedule.cu",
        replaces="src/repro/kernels/dcn_schedule.py:62 + :142 (one launch)",
        max_abs_err=0.0,
        ms=cuda_time_ms(call_g.launch, 200),
        wrapper_ms=cuda_time_ms(lambda: ks.schedule_group_batch(*a_g, **k_g),
                                200),
        launch_floor_ms=cuda_time_ms(empty_launch, 200),
        plain_ms=cuda_time_ms(
            lambda: ks.schedule_group_batch_plain(*a_g, **k_g), 3),
        library_ms=None, ops=dict(fp32=0),
        bytes=sum(x[0].numel() * 4 * len(a_g[1]) for x in coords_g)
        + out_g.buf.numel() * 4,
        shape=f"{len(a_g[1])} images, coords "
              f"{[tuple(x.shape[1:]) for x in coords_g]} -> "
              f"({a_g[2].num_tiles}, {a_g[2].num_tiles}), m={a_g[3]}, bare "
              f"launch into preallocated outputs")

    # (4) one image's schedule, first DCN group of the batched prepass.
    a4, k4 = captured["sched"][0]
    err4 = hold_fused("dcn_fused_schedule", captured["sched"],
                      kf.dcn_fused_schedule, kf.dcn_fused_schedule_plain,
                      FUSED_RTOL)
    x4, dep4, cnt4, idx4, cf4, w4 = a4[:6]
    t4, p4 = idx4.shape[:2]
    live4 = int((cnt4 > 0).sum())
    kernels["dcn_fused_schedule"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_fused_schedule.cu",
        replaces="src/repro/kernels/dcn_fused.py:116", max_abs_err=err4,
        ms=cuda_time_ms(lambda: kf.dcn_fused_schedule(*a4, **k4), 50),
        plain_ms=cuda_time_ms(lambda: kf.dcn_fused_schedule_plain(*a4), 5),
        library_ms=contraction(t4 * p4, w4),
        ops=fused_ops(live4 * p4, *w4.shape, "3xtf32"),
        bytes=nbytes_of(a4, t4 * p4 * w4.shape[2]),
        shape=f"T={t4} T_in={x4.shape[0]} tp={x4.shape[1]} P={p4} "
              f"KK={w4.shape[0]} C={w4.shape[1]} O={w4.shape[2]} "
              f"k_pad={dep4.shape[1]} live_rows={live4}")

    # (5) one tile with its halo resident: held here on the whole
    # 14x14x512 plane of deformable_conv2d_pallas; the per_tile path's own
    # tiles are captured and held in phase 3c, where it is also timed.
    a5, k5 = captured["plane_tile"][0]
    err5_plane = hold_fused("dcn_fused_tile (whole plane)",
                            captured["plane_tile"], kf.dcn_fused_tile,
                            kf.dcn_fused_tile_plain, FUSED_RTOL)
    x5, idx5, cf5, w5 = a5[:4]
    live5 = int((cf5.reshape(*cf5.shape[:-2], -1) != 0).any(-1).sum())
    plane_tile = dict(
        err=err5_plane,
        ms=cuda_time_ms(lambda: kf.dcn_fused_tile(*a5, **k5), 50),
        plain_ms=cuda_time_ms(lambda: kf.dcn_fused_tile_plain(*a5), 5),
        library_ms=contraction(idx5.shape[-3], w5),
        **bound_of(fused_ops(live5, *w5.shape, "3xtf32"),
                   nbytes_of(a5, idx5.shape[-3] * w5.shape[2])),
        shape=f"S={x5.shape[-2]} P={idx5.shape[-3]} live={live5} "
              f"KK={w5.shape[0]} C={w5.shape[1]} O={w5.shape[2]}")

    # (6) standalone BLI at the 14x14x512 DCN layer: the captured calls of
    # one image (the serving shape, the main entry) and of a serving
    # step's four, each in float32 and in bfloat16 (the same planes
    # rounded); and a random 56x56x256 plane (S = 3136), far larger than
    # the 14x14 one. Each is held against the plain version and rerun
    # bitwise, and timed beside an empty kernel (launch_floor_ms), with
    # its own device time from torch.profiler (device_ms), the plain
    # version and embedding_bag over the same bags.
    floor_ms = cuda_time_ms(empty_launch, 200)

    def bli_device_ms(a, n=20, cold=True):
        """Mean device duration of the BLI kernel over ``n`` calls (each
        after the L2 flush unless not ``cold``), as torch.profiler
        records it behind PROFILE_LEAD empty launches. A window that
        still lost a BLI record is profiled again behind a lead-in four
        times as long, up to four windows, and only a window with all
        ``n`` records counts."""
        lead = PROFILE_LEAD
        for _ in range(4):
            d, seen = profiled_window(lambda: kb.bli_tile_matmul(*a),
                                      "bli_kernel", n, cold, lead)
            if len(d) == n:
                return sum(d) / n / 1e3
            print(f"[kernels] the profiler saw {len(d)} BLI kernels in {n} "
                  f"calls ({seen} device records of the "
                  f"{lead + (3 if cold else 2) * n} launched); profiling "
                  f"the window again behind {4 * lead} empty launches")
            lead *= 4
        fail(f"the profiler saw {len(d)} BLI kernels in {n} calls, four "
             f"windows running")

    def bli_record(what, a):
        """#6 on the operands ``a``: held, rerun, timed."""
        x, idx, cf = a
        n, s, c = x.shape
        p = idx.shape[1]
        got = kb.bli_tile_matmul(*a)
        plan = kb.bli_tile_matmul.last_plan
        d, sc = rel_err(got.float(), kb.bli_tile_plain(*a).float())
        tol = {torch.float32: BLI_RTOL, torch.float16: F16_RTOL}.get(
            x.dtype, BLI_BF16_RTOL)
        if not d <= tol * sc:
            fail(f"bli_tile_matmul {what}: max|d|={d} > {tol}*{sc}")
        if not torch.equal(kb.bli_tile_matmul(*a), got):
            fail(f"bli_tile_matmul {what}: a rerun differs")
        live = int((cf != 0).any(-1).sum())
        rec = dict(max_abs_err=d, ms=cuda_time_ms(
            lambda: kb.bli_tile_matmul(*a), 200), launch_floor_ms=floor_ms,
            write_ms=cuda_time_ms(torch.empty_like(got).zero_, 200),
            device_ms=bli_device_ms(a),
            device_warm_ms=bli_device_ms(a, cold=False),
            plain_ms=cuda_time_ms(lambda: kb.bli_tile_plain(*a), 20),
            library_ms=None, plan=plan._asdict(), ops=dict(fp32=8 * live * c),
            bytes=sum(t.numel() * t.element_size() for t in a)
            + n * p * c * x.element_size(),
            shape=f"{what}: N={n} S={s} P={p} (live {live}) C={c} "
                  f"{str(x.dtype).removeprefix('torch.')}, grid {plan.grid}, "
                  f"{plan.rows} rows a block")
        if bool(((idx >= 0) & (idx < s)).all()):
            bags = (idx.long() + s * torch.arange(n, device=dev)[:, None,
                                                              None])
            bags, table = bags.reshape(-1, 4), x.reshape(n * s, c)
            weights = cf.reshape(-1, 4).to(x.dtype)
            rec["library_ms"] = cuda_time_ms(
                lambda: torch.nn.functional.embedding_bag(
                    bags, table, per_sample_weights=weights, mode="sum"),
                200)
        b = bound_of(rec["ops"], rec["bytes"])
        print(f"[kernels] {card}: bli_tile_matmul {rec['shape']}: "
              f"{rec['ms']:.4f} ms (launch floor {floor_ms:.4f}, zero_ of "
              f"the output {rec['write_ms']:.4f}; device "
              f"{rec['device_ms']:.4f} = "
              f"{100 * b['bound_ms'] / rec['device_ms']:.1f} % of the "
              f"{b['bound_ms']:.4f} ms {b['bound_by']} bound, "
              f"{rec['device_warm_ms']:.4f} with a warm L2), plain "
              f"{rec['plain_ms']:.4f}, embedding_bag "
              f"{'none' if rec['library_ms'] is None else round(rec['library_ms'], 4)}"
              f"; max|d| {d:.3e} (limit {tol}*{sc:.3f})")
        return rec

    a6, _ = captured["bli"][0]
    a6x4, _ = captured["bli"][1]
    bf = torch.bfloat16
    rng6 = np.random.default_rng(SEED + 6)
    big = (torch.as_tensor(rng6.normal(size=(1, 3136, 256)).astype(
               np.float32), device=dev),
           torch.as_tensor(rng6.integers(0, 3136, size=(1, 1024, 4)).astype(
               np.int32), device=dev),
           torch.as_tensor(rng6.uniform(size=(1, 1024, 4)).astype(
               np.float32), device=dev))
    kernels["bli_tile_matmul"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_bli.cu",
        replaces="src/repro/kernels/dcn_bli.py:32",
        **bli_record("serving shape", a6),
        shapes={
            "N=1 bf16": bli_record("serving shape", (a6[0].to(bf), *a6[1:])),
            "N=4 f32": bli_record("serving step", a6x4),
            "N=4 bf16": bli_record("serving step",
                                   (a6x4[0].to(bf), *a6x4[1:])),
            "S=3136 f32": bli_record("56x56x256 plane", big)})

    def greedy_record(calls, where):
        """#3 on its path: each distinct (table shape, m) timed once by its
        bare launch into preallocated outputs (and through its wrapper),
        its launches counted; the kernel's line carries the
        launch-weighted mean per launch, and the per-shape times and their
        sum over the launches (what the path spends in #3)."""
        shapes = {}
        for (bt, m), _ in calls:
            key = (tuple(bt.shape), m)
            shapes.setdefault(key, [bt, m, 0])[2] += 1
        rows = []
        for (shape, m), (bt, _, n) in sorted(shapes.items()):
            outs = (torch.empty((shape[0], 1), dtype=torch.int32, device=dev),
                    torch.empty(shape, dtype=torch.int32, device=dev),
                    torch.empty((shape[0], 1), dtype=torch.int32, device=dev))
            rows.append(dict(
                shape=list(shape), m=m, launches=n,
                ms=cuda_time_ms(ks.plan_greedy(bt, m, *outs).launch, 10),
                wrapper_ms=cuda_time_ms(
                    lambda: ks.greedy_schedule_arrays(bt, m), 10),
                plain_ms=cuda_time_ms(lambda: ks.greedy_plain(bt, m), 1,
                                      warmup=1),
                bytes=shape[0] * shape[1] * (1 + 4) + 8 * shape[0]))
            rows[-1]["bound_ms"] = rows[-1]["bytes"] / peak_bw * 1e3
        n = sum(r["launches"] for r in rows)

        def mean(key):
            return sum(r["launches"] * r[key] for r in rows) / n
        kernels["greedy_schedule_arrays"].update(
            ms=mean("ms"), wrapper_ms=mean("wrapper_ms"),
            plain_ms=mean("plain_ms"), bytes=int(mean("bytes")),
            charged_ms=sum(r["launches"] * r["ms"] for r in rows),
            by_shape=rows,
            shape=f"{len(rows)} TDT shapes on {where}, launch-weighted mean "
                  f"of bare launches")
        for r in rows:
            print(f"[{where}] greedy_schedule_arrays at TDT "
                  f"{tuple(r['shape'])}, m={r['m']}: {r['launches']} launches "
                  f"x {r['ms']:.4f} ms (wrapper {r['wrapper_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.6f} ms by bytes, plain "
                  f"{r['plain_ms']:.2f} ms)")
        print(f"[{where}] greedy_schedule_arrays: {n} launches, "
              f"{kernels['greedy_schedule_arrays']['charged_ms']:.3f} ms in "
              f"all")

    def group_record(calls, steps, n_groups):
        """The group kernel on the serving path: each distinct call shape
        (listed images, tiles, layers, m) timed once by its bare launch,
        charged by its calls; at most one launch per group and step."""
        n = launches["schedule_group_batch"]
        if n != len(calls) or n > n_groups * steps:
            fail(f"schedule_group_batch: {n} launches ({len(calls)} calls) "
                 f"for {n_groups} groups x {steps} steps")
        shapes = {}
        for a, k in calls:
            key = (len(a[1]), a[2].num_tiles, a[3],
                   tuple("conv" if isinstance(x, int) else "dcn"
                         for x in a[0]))
            shapes.setdefault(key, [a, k, 0])[2] += 1
        rows = []
        for key, (a, k, cnt) in sorted(shapes.items(), key=str):
            out = ks.schedule_group_batch(*a, **k)
            rows.append(dict(images=key[0], tiles=key[1], m=key[2],
                             layers=list(key[3]), calls=cnt,
                             ms=cuda_time_ms(ks.plan_group(
                                 a[0], out, a[2], a[3]).launch, 50)))
        charged = sum(r["calls"] * r["ms"] for r in rows)
        kernels["schedule_group_batch"].update(by_shape=rows,
                                               charged_ms=charged)
        for r in rows:
            print(f"[serve] schedule_group_batch, {r['images']} images x "
                  f"({r['tiles']}, {r['tiles']}) tiles, m={r['m']}, layers "
                  f"{r['layers']}: {r['calls']} launches x {r['ms']:.4f} ms")
        kd = kernels["schedule_group_batch"]
        print(f"[serve] {card}: schedule_group_batch: {n} launches in "
              f"{steps} steps ({n_groups} fused groups), {charged:.4f} ms "
              f"charged; {kd['ms']:.4f} ms a call at the serving shape "
              f"({kd['shape']}), wrapper {kd['wrapper_ms']:.4f} ms, launch "
              f"floor {kd['launch_floor_ms']:.4f} ms")

    print(f"[kernels] all {sum(len(v) for v in captured.values())} captured "
          f"calls agree with their plain versions (fused kernels within "
          f"{FUSED_RTOL}*max|ref|, BLI within {BLI_RTOL}*max|ref|, TDT, "
          f"greedy and group kernel bit-exact, greedy and group also == "
          f"numpy schedule_tiles)")
    print(f"[kernel] {card}: dcn_fused_tile on the whole plane "
          f"({plane_tile['shape']}): {plane_tile['ms']:.4f} ms (bound "
          f"{plane_tile['bound_ms']:.4f} ms by {plane_tile['bound_by']} at "
          f"{plane_tile['bound_rate']}, plain "
          f"{plane_tile['plain_ms']:.4f} ms, library "
          f"{plane_tile['library_ms']:.4f} ms), max|d| "
          f"{plane_tile['err']:.3e}")

    # -- phase 3: the main path ---------------------------------------------
    requests = [[0], [1, 2], [3], [4, 5], [6], [0], [7, 8], [9]]

    def make_engine(backend, slots=4, **graph_kw):
        eng = DcnServingEngine(
            params, cfg, slots=slots, device=dev,
            graph=fx.GraphConfig(tile=8, schedule_backend=backend,
                                 **graph_kw))
        eng.submit(images[10:12])          # warm-up: cuDNN, conv schedules
        eng.drain()
        return eng

    def serve(eng):
        """Submit every request, step until all resolve; per-step traces."""
        reqs = [eng.submit(images[ids]) for ids in requests]
        traces, done = [], []
        t0 = time.perf_counter()
        while len(done) < len(reqs):
            done += eng.step()
            traces.append(eng.last_trace)
        torch.cuda.synchronize()
        return reqs, traces, time.perf_counter() - t0

    def no_ladder(what, eng):
        st = eng.stats
        if st["step_retries"] or st["degraded_steps"]:
            fail(f"{what}: {st['step_retries']} retries and "
                 f"{st['degraded_steps']} degraded steps without an "
                 f"injected fault")

    eng = make_engine("device")
    builds0 = eng.host_schedule_builds
    served_groups = []
    reset_counts()
    with recording(fx, "schedule_group_batch", served_groups):
        reqs, traces, wall = serve(eng)
    read_counts("dcn_fused_batch", "schedule_group_batch")
    builds = eng.host_schedule_builds - builds0
    steps = len(traces)
    group_record(served_groups, steps,
                 len({g.group for t in traces for g in t.groups}))
    no_ladder("serve", eng)
    if builds != 0:
        fail(f"{builds} host schedule builds on the device-scheduled path")
    bad = [r.rid for r in reqs if not r.done or r.error is not None]
    if bad:
        fail(f"requests {bad} did not resolve cleanly: "
             f"{[repr(r.error) for r in reqs if r.error]}")
    worst = max(check_logits(f"request {r.rid}", r.result(),
                             dense_logits(images[ids]))
                for r, ids in zip(reqs, requests))
    print(f"[serve] {len(reqs)} requests, {sum(map(len, requests))} images "
          f"in {steps} steps; logits finite; max|served - dense| / "
          f"max|dense| = {worst:.3e} (limit {LOGIT_RTOL})")
    check_sim("serve", traces)

    def records(tr):
        return [[(g.image, g.group)] + [dataclasses.astuple(r)
                                        for r in g.records]
                for g in tr.groups]

    host_eng = make_engine("host")
    _, host_traces, _ = serve(host_eng)
    no_ladder("host-scheduled serve", host_eng)
    if [records(t) for t in traces] != [records(t) for t in host_traces]:
        fail("device- and host-scheduled engines produced different "
             "trace records")
    if host_eng.host_schedule_builds == 0:
        fail("the host-scheduled engine built no host schedule")
    print(f"[serve] trace == DRAM simulator on all {steps} steps; host-"
          f"scheduled engine gives identical records; no retried or "
          f"degraded step")

    lat = sorted(r.latency_s for r in reqs)
    n_img = sum(map(len, requests))

    def pct(q):
        return float(np.percentile(np.asarray(lat), q))

    stats = eng.stats
    print(f"[serve] {card}: {n_img / wall:.3f} images/s, request latency "
          f"p50 {pct(50) * 1e3:.1f} ms p99 {pct(99) * 1e3:.1f} ms, "
          f"{steps} steps, {stats['kernel_dispatches']} dispatches, "
          f"schedule-cache image hit rate {stats['image_hit_rate']:.3f}")

    # -- phase 3b: fault-tolerant serving, the degraded step -----------------
    def fault_engine(graph=None, **plan):
        inj = FaultInjector(**plan)
        e = DcnServingEngine(
            params, cfg, slots=4, device=dev, faults=inj,
            graph=graph or fx.GraphConfig(tile=8, schedule_backend="device"))
        seen = []
        absorb = e._absorb_trace

        def keep(tr):
            seen.append(tr)
            absorb(tr)

        e._absorb_trace = keep
        return e, inj, seen

    def fault_run(ids, graph=None, **plan):
        e, inj, seen = fault_engine(graph, **plan)
        rq = [e.submit(images[i]) for i in ids]
        t0 = time.perf_counter()
        done = e.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if sorted(r.rid for r in done) != [r.rid for r in rq]:
            fail(f"fault run {plan}: requests did not resolve exactly once")
        check_sim(f"fault run {plan}", seen)
        return e, inj, rq, wall

    # Tagged: the fault names its image; that request fails, its
    # step-mates resolve through the evicted retry.
    tag_ids = [10, 11, 12, 13]
    e_t, inj_t, rq_t, _ = fault_run(tag_ids, kinds=("dispatch",), rate=1.0,
                                    max_fires=1, seed=3)
    failed = [r for r in rq_t if r.failed]
    st = e_t.stats
    if (inj_t.fired["dispatch"] != 1 or len(failed) != 1
            or not isinstance(failed[0].error, RequestFailedError)
            or not isinstance(failed[0].error.__cause__, FaultError)
            or (st["step_retries"], st["degraded_steps"]) != (1, 0)):
        fail(f"tagged fault: fired {inj_t.fired}, failed "
             f"{[repr(r.error) for r in failed]}, retries "
             f"{st['step_retries']}, degraded {st['degraded_steps']}")
    for r, i in zip(rq_t, tag_ids):
        if not r.failed:
            check_logits(f"tagged-fault step-mate {r.rid}", r.result(),
                         dense_logits(images[i:i + 1]))
    print(f"[faults] tagged dispatch fault: request {failed[0].rid} failed "
          f"with RequestFailedError({type(failed[0].error.__cause__).__name__}"
          f"), its {len(rq_t) - 1} step-mates served by the evicted retry; "
          f"retries 1, degraded 0")

    # Untagged: no image to evict, so the step degrades to per-image
    # batched dispatch through the schedule kernel.
    deg_ids = [4, 5, 6, 7]
    reset_counts()
    deg_greedy = []
    with recording(sched_mod, "greedy_schedule_arrays", deg_greedy):
        e_u, inj_u, rq_u, wall_u = fault_run(
            deg_ids, kinds=("dispatch",), rate=1.0, max_fires=1,
            tag_image=False, seed=7)
    deg_counts = read_counts("dcn_fused_schedule", "tdt_from_coords_device",
                             "greedy_schedule_arrays")
    greedy_record(deg_greedy, "faults")
    st = e_u.stats
    if (inj_u.fired["dispatch"] != 1 or any(r.failed for r in rq_u)
            or st["degraded_steps"] < 1 or st["step_retries"] != 1):
        fail(f"untagged fault: fired {inj_u.fired}, failed "
             f"{[r.rid for r in rq_u if r.failed]}, stats {st}")
    if any(g.dispatch != "batched" for g in e_u.last_trace.groups):
        fail("the degraded step did not run dispatch='batched'")
    worst_u = 0.0
    for r, i in zip(rq_u, deg_ids):
        out = r.result()
        worst_u = max(worst_u,
                      check_logits(f"degraded request {r.rid}", out,
                                   dense_logits(images[i:i + 1])),
                      check_logits(f"degraded request {r.rid} vs infer()",
                                   out, e_u.infer(images[i:i + 1])
                                   .cpu().numpy()))
    print(f"[faults] untagged dispatch fault: the step degraded to "
          f"per-image batched dispatch ({st['degraded_steps']} degraded, "
          f"{st['step_retries']} retried) in {wall_u * 1e3:.1f} ms; "
          f"dcn_fused_schedule launched {deg_counts['dcn_fused_schedule']} "
          f"times, tdt_from_coords_device "
          f"{deg_counts['tdt_from_coords_device']}, greedy_schedule_arrays "
          f"{deg_counts['greedy_schedule_arrays']}; {len(rq_u)} requests "
          f"served, max rel. deviation from "
          f"dense and infer() {worst_u:.3e}; traces == simulator")

    # -- phase 3c: per_tile dispatch, the pallas/pipeline backends, BLI ------
    x1 = torch.as_tensor(images[14:15], device=dev)
    ref1 = dense_logits(images[14:15])
    reset_counts()
    tile_calls = []
    t0 = time.perf_counter()
    with recording(fx, "dcn_fused_tile", tile_calls):
        y_pt, tr_pt = fx.run_graph(
            params["convs"], graph, x1,
            config=fx.GraphConfig(tile=8, dispatch="per_tile",
                                  schedule_backend="device"),
            schedule_cache=ScheduleCache(), return_trace=True)
    torch.cuda.synchronize()
    wall_pt = time.perf_counter() - t0
    read_counts("dcn_fused_tile")
    check_logits("per_tile", apply_head(params, cfg, y_pt).cpu().numpy(),
                 ref1)
    check_sim("per_tile", [tr_pt])
    err5 = hold_fused("dcn_fused_tile (per_tile path)", tile_calls,
                      kf.dcn_fused_tile, kf.dcn_fused_tile_plain, FUSED_RTOL)
    a5t, k5t = tile_calls[0]
    x5t, idx5t, cf5t, w5t = a5t[:4]
    live5t = int((cf5t.reshape(cf5t.shape[0], -1) != 0).any(-1).sum())
    kernels["dcn_fused_tile"] = dict(
        route="cuda", source="src/repro_torch/csrc/dcn_fused_schedule.cu",
        replaces="src/repro/kernels/dcn_fused.py:38", max_abs_err=err5,
        ms=cuda_time_ms(lambda: kf.dcn_fused_tile(*a5t, **k5t), 50),
        plain_ms=cuda_time_ms(lambda: kf.dcn_fused_tile_plain(*a5t), 5),
        library_ms=contraction(idx5t.shape[0], w5t),
        ops=fused_ops(live5t, *w5t.shape, "3xtf32"),
        bytes=nbytes_of(a5t, idx5t.shape[0] * w5t.shape[2]),
        shape=f"S={x5t.shape[0]} P={idx5t.shape[0]} live={live5t} "
              f"KK={w5t.shape[0]} C={w5t.shape[1]} O={w5t.shape[2]}")
    print(f"[modes] per_tile at {cfg.img_size}x{cfg.img_size}: "
          f"{tr_pt.kernel_dispatches} dispatches "
          f"({launches['dcn_fused_tile']} tile-kernel launches, "
          f"{tr_pt.total_recomputes} recomputes) in {wall_pt:.2f} s; logits "
          f"match dense; trace == simulator")
    for backend in ("pallas", "pipeline"):
        out = dcn_net_apply(params, cfg, x1, backend=backend).cpu().numpy()
        d = check_logits(f"backend={backend}", out, ref1)
        print(f"[modes] dcn_net_apply(backend={backend!r}): max rel. "
              f"deviation from dense {d:.3e}")
    reset_counts()
    deformed = ops.bli_pallas(dcn_in, dcn_coords)
    torch.cuda.synchronize()
    read_counts("bli_tile_matmul")
    d, sc = rel_err(deformed, bilinear_sample(dcn_in, dcn_coords))
    if not d <= BLI_RTOL * sc:
        fail(f"bli_pallas vs bilinear_sample: max|d|={d} > {BLI_RTOL}*{sc}")
    print(f"[modes] bli_pallas {tuple(deformed.shape)} vs bilinear_sample: "
          f"max|d| {d:.3e} (limit {BLI_RTOL}*{sc:.3f})")

    # -- phase 3d: the autotuned plan on the serving path --------------------
    # The README's autotuning setting: a bounded FIFO of 6 tiles, so the
    # tuner has halo reloads to trade. The default search budget (128
    # simulator evaluations) is kept.
    ips = {"phase 3 (greedy, FIFO = all tiles)": [n_img / wall]}
    with tempfile.TemporaryDirectory(prefix="plans-") as plan_dir:
        tuned_kw = dict(buffer_tiles=6, autotune="offline",
                        plan_cache_dir=plan_dir)
        # The warm-up's group calls are kept too: standard-conv groups
        # are scheduled once, by it, and hit the schedule cache after.
        t_group_warm = []
        t0 = time.perf_counter()
        with recording(fx, "schedule_group_batch", t_group_warm):
            eng_t = make_engine("device", **tuned_kw)
        build_s = time.perf_counter() - t0
        plan = eng_t.tuned_plan
        if plan is None or eng_t.stats["autotune_search_s"] <= 0:
            fail("the offline engine resolved no plan by a search")
        if not plan.dram_bytes <= plan.greedy_dram_bytes:
            fail(f"tuned plan {plan.dram_bytes} B > greedy "
                 f"{plan.greedy_dram_bytes} B")
        greedy_segs = [sg for sg in partition_graph_cached(
            graph, eng_t._step_cfg.onchip_budget_bytes)
            if isinstance(sg, FusedGroup)]
        greedy_spans = []
        for sg in greedy_segs:
            first = graph.nodes.index(sg.nodes[0])
            greedy_spans.append((first, first + sg.n_layers))
        plan_tiles = []
        for g in plan.groups:
            nd = graph.nodes[g.start]
            plan_tiles.append((min(g.tile_h, nd.h), min(g.tile_w, nd.w)))
        print(f"[tune] {card}: search {plan.search_s:.3f} s over "
              f"{plan.candidates} simulator evaluations (budget "
              f"{eng_t._step_cfg.autotune_budget}), engine built in "
              f"{build_s:.2f} s (search and 2-image warm-up); simulated "
              f"DRAM {plan.dram_bytes} B tuned vs {plan.greedy_dram_bytes} B "
              f"greedy ({plan.dram_bytes - plan.greedy_dram_bytes:+d} B an "
              f"image)")
        for g, tl in zip(plan.groups, plan_tiles):
            nd = graph.nodes[g.start]
            moved = ("" if ((g.start, g.stop) in greedy_spans
                            and tl == (min(8, nd.h), min(8, nd.w)))
                     else "  <- differs from greedy")
            kinds = "".join("D" if isinstance(graph.nodes[i], DeformNode)
                            else "C" for i in range(g.start, g.stop))
            print(f"  group nodes [{g.start}, {g.stop}) {kinds} at "
                  f"{nd.h}x{nd.w}x{nd.c_in}: tile {tl[0]}x{tl[1]} "
                  f"({TileGrid(nd.h, nd.w, *tl).num_tiles} tiles){moved}")

        # Serve phase 3's requests through the tuned plan.
        t_fused, t_group = [], []
        builds0 = eng_t.host_schedule_builds
        tuned_launches = {}
        reset_counts()
        with recording(fx, "dcn_fused_batch", t_fused), \
                recording(fx, "schedule_group_batch", t_group):
            reqs_t, traces_t, wall_t = serve(eng_t)
        read_counts("dcn_fused_batch", "schedule_group_batch",
                    into=tuned_launches)
        no_ladder("tuned serve", eng_t)
        if eng_t.host_schedule_builds != builds0:
            fail("host schedule builds on the tuned device-scheduled path")
        worst_t = max(check_logits(f"tuned request {r.rid}", r.result(),
                                   dense_logits(images[ids]))
                      for r, ids in zip(reqs_t, requests))
        check_sim("tuned serve", traces_t)
        for tr in traces_t:
            got = [(g.grid.th, g.grid.tw) for g in tr.groups if g.image == 0]
            if got != plan_tiles:
                fail(f"a tuned step ran the grids {got}, the plan says "
                     f"{plan_tiles}")
        n_groups_t = len(plan.groups)
        if tuned_launches["schedule_group_batch"] > n_groups_t * len(
                traces_t):
            fail(f"schedule_group_batch launched "
                 f"{tuned_launches['schedule_group_batch']} times for "
                 f"{n_groups_t} groups x {len(traces_t)} steps")
        ips["tuned (FIFO 6)"] = [n_img / wall_t]
        print(f"[tune] {len(reqs_t)} requests in {len(traces_t)} steps "
              f"through the tuned plan: logits finite, max|served - dense| "
              f"/ max|dense| = {worst_t:.3e} (limit {LOGIT_RTOL}); every "
              f"step ran the plan's grids and equals the DRAM simulator; no "
              f"retry, no degraded step, no host schedule build; "
              f"dcn_fused_batch {tuned_launches['dcn_fused_batch']} "
              f"launches, schedule_group_batch "
              f"{tuned_launches['schedule_group_batch']}")

        # The executed (trace) DRAM bytes beside a greedy engine at the
        # same FIFO depth: bytes, not a speed.
        eng_g6 = make_engine("device", buffer_tiles=6)
        reqs_g6, traces_g6, wall_g6 = serve(eng_g6)
        no_ladder("greedy FIFO-6 serve", eng_g6)
        check_sim("greedy FIFO-6 serve", traces_g6)
        ips["greedy (FIFO 6)"] = [n_img / wall_g6]
        dram_t = sum(tr.total_dram_bytes for tr in traces_t)
        dram_g = sum(tr.total_dram_bytes for tr in traces_g6)
        print(f"[tune] executed DRAM of the {n_img} images (trace == "
              f"simulator): tuned {dram_t} B, greedy at FIFO 6 {dram_g} B "
              f"({dram_t - dram_g:+d} B, "
              f"{100 * (dram_t - dram_g) / dram_g:+.3f} %)")

        def host_split(traces, wall_s):
            ms = [sum(getattr(tr.overlap, f) for tr in traces) * 1e3
                  for f in ("prepass_s", "prepass_wait_s", "schedule_s")]
            return (f"wall {wall_s * 1e3:.1f} ms, host prepass {ms[0]:.1f} "
                    f"ms (waited on {ms[1]:.1f}), schedule build "
                    f"{ms[2]:.1f} ms")
        print(f"[tune] {card}: serving the {n_img} images, tuned: "
              f"{host_split(traces_t, wall_t)}; greedy at FIFO 6: "
              f"{host_split(traces_g6, wall_g6)}")
        del eng_g6, reqs_g6, traces_g6

        # A second engine serves the plan from the cache, searching
        # nothing; a fresh cache over the directory reads it from disk.
        eng_c = DcnServingEngine(
            params, cfg, slots=4, device=dev,
            graph=fx.GraphConfig(tile=8, schedule_backend="device",
                                 **dict(tuned_kw, autotune="cached-only")))
        st_c = eng_c.stats
        if (st_c["plan_cache_hits"] < 1 or st_c["autotune_search_s"] != 0
                or eng_c.tuned_plan != plan):
            fail(f"cached-only engine: hits {st_c['plan_cache_hits']}, "
                 f"search {st_c['autotune_search_s']} s, same plan "
                 f"{eng_c.tuned_plan == plan}")
        disk = PlanCache(cache_dir=plan_dir)
        if disk.get(plan.key) != plan or disk.disk_hits != 1:
            fail("the plan file does not read back from disk")
        print(f"[tune] cached-only engine: {st_c['plan_cache_hits']} plan "
              f"cache hit, search 0 s, the same plan; a fresh cache reads "
              f"it back from {len(os.listdir(plan_dir))} file(s)")
        del eng_c

        # Two more serving runs for images/s, in turns after the two
        # above (tuned, greedy, greedy, tuned), each on a fresh engine
        # with its own schedule cache, warmed up on two other images.
        for name, mode in (("greedy (FIFO 6)", "off"),
                           ("tuned (FIFO 6)", "cached-only")):
            e_turn = make_engine("device", **dict(tuned_kw, autotune=mode))
            _, _, w_turn = serve(e_turn)
            no_ladder(f"{name} serve", e_turn)
            ips[name].append(n_img / w_turn)
            del e_turn

        # #1 and the group launch at every call shape of the tuned run,
        # held against their plain versions and timed beside phase 3's
        # tile-8 numbers.
        err_t = hold_fused("dcn_fused_batch (tuned run)", t_fused,
                           kf.dcn_fused_batch, kf.dcn_fused_batch_plain,
                           FUSED_RTOL)
        fused_rows = {}
        for a, k in t_fused:
            key = (a[1].shape[0], a[4].shape[1], a[6].shape[1],
                   a[6].shape[2], a[2].shape[1])
            if key in fused_rows:
                fused_rows[key]["calls"] += 1
                continue
            kk_t, c_t, o_t = a[6].shape
            live_t = int((a[3] > 0).sum())
            row = dict(
                shape=f"G={key[0]} P={key[1]} KK={kk_t} C={c_t} O={o_t} "
                      f"k_pad={key[4]} live_rows={live_t}", calls=1,
                ms=cuda_time_ms(lambda: kf.dcn_fused_batch(*a, **k), 50),
                plain_ms=cuda_time_ms(
                    lambda: kf.dcn_fused_batch_plain(*a, **k), 5),
                library_ms=contraction(key[0] * key[1], a[6]),
                **bound_of(fused_ops(live_t * key[1], kk_t, c_t, o_t,
                                     "3xtf32"),
                           nbytes_of(a, key[0] * key[1] * o_t)))
            fused_rows[key] = row
        for row in fused_rows.values():
            print(f"[tune] {card}: dcn_fused_batch at {row['shape']}: "
                  f"{row['calls']} launches x {row['ms']:.4f} ms (bound "
                  f"{row['bound_ms']:.4f} ms by {row['bound_by']}, plain "
                  f"{row['plain_ms']:.4f} ms, library "
                  f"{row['library_ms']:.4f} ms); tile-8 serving shape "
                  f"{kernels['dcn_fused_batch']['ms']:.4f} ms")
        kernels["dcn_fused_batch"]["tuned"] = dict(
            launches=tuned_launches["dcn_fused_batch"], max_abs_err=err_t,
            by_shape=list(fused_rows.values()))
        group_rows = {}
        for run, calls in (("warm_up_calls", t_group_warm),
                           ("calls", t_group)):
            for a, k in calls:
                key = (len(a[1]), a[2].num_tiles, a[2].th, a[2].tw, a[3],
                       tuple("conv" if isinstance(x, int) else "dcn"
                             for x in a[0]))
                if key not in group_rows:
                    hold_group(f"schedule_group_batch (tuned run) {key}", a,
                               k)
                    out = ks.schedule_group_batch(*a, **k)
                    group_rows[key] = dict(
                        images=key[0], tiles=key[1], tile=[key[2], key[3]],
                        m=key[4], layers=list(key[5]), calls=0,
                        warm_up_calls=0, ms=cuda_time_ms(ks.plan_group(
                            a[0], out, a[2], a[3]).launch, 50))
                group_rows[key][run] += 1
        tile8 = {(r["images"], r["tiles"], tuple(r["layers"])): r["ms"]
                 for r in kernels["schedule_group_batch"]["by_shape"]}
        for r in group_rows.values():
            was = tile8.get((r["images"], r["tiles"], tuple(r["layers"])))
            print(f"[tune] {card}: schedule_group_batch, {r['images']} "
                  f"images x {r['tiles']} tiles of {r['tile'][0]}x"
                  f"{r['tile'][1]}, m={r['m']}, layers {r['layers']}: "
                  f"{r['calls']} launches in the served run, "
                  f"{r['warm_up_calls']} in the warm-up, x {r['ms']:.4f} ms "
                  f"(held bit-exact; tile-8 run at this table size: "
                  f"{'none' if was is None else f'{was:.4f} ms'})")
        kernels["schedule_group_batch"]["tuned"] = dict(
            launches=tuned_launches["schedule_group_batch"],
            charged_ms=sum(r["calls"] * r["ms"]
                           for r in group_rows.values()),
            by_shape=list(group_rows.values()))

        # An untagged dispatch fault on the tuned engine: the degraded
        # step replays the tuned plan per image through #4, #2 and #3.
        reset_counts()
        e_tu, inj_tu, rq_tu, wall_tu = fault_run(
            deg_ids, graph=fx.GraphConfig(tile=8, schedule_backend="device",
                                          **tuned_kw),
            kinds=("dispatch",), rate=1.0, max_fires=1, tag_image=False,
            seed=7)
        deg_t = read_counts("dcn_fused_schedule", "tdt_from_coords_device",
                            "greedy_schedule_arrays", into={})
        st = e_tu.stats
        if (inj_tu.fired["dispatch"] != 1 or any(r.failed for r in rq_tu)
                or st["degraded_steps"] < 1 or e_tu.tuned_plan != plan):
            fail(f"tuned untagged fault: fired {inj_tu.fired}, failed "
                 f"{[r.rid for r in rq_tu if r.failed]}, stats {st}")
        deg_grids = [(g.grid.th, g.grid.tw) for g in e_tu.last_trace.groups
                     if g.image == 0]
        if (any(g.dispatch != "batched" for g in e_tu.last_trace.groups)
                or deg_grids != plan_tiles):
            fail(f"the tuned degraded step ran grids {deg_grids}, the plan "
                 f"says {plan_tiles}")
        worst_tu = 0.0
        for r, i in zip(rq_tu, deg_ids):
            out = r.result()
            worst_tu = max(worst_tu,
                           check_logits(f"tuned degraded request {r.rid}",
                                        out, dense_logits(images[i:i + 1])),
                           check_logits(f"tuned degraded request {r.rid} vs "
                                        f"infer()", out,
                                        e_tu.infer(images[i:i + 1])
                                        .cpu().numpy()))
        for name, n in deg_t.items():
            kernels[name]["tuned"] = dict(degraded_step_launches=n)
        print(f"[tune] untagged dispatch fault on the tuned engine: the "
              f"step degraded to batched dispatch on the plan's grids in "
              f"{wall_tu * 1e3:.1f} ms; dcn_fused_schedule "
              f"{deg_t['dcn_fused_schedule']} launches, "
              f"tdt_from_coords_device {deg_t['tdt_from_coords_device']}, "
              f"greedy_schedule_arrays {deg_t['greedy_schedule_arrays']}; "
              f"max rel. deviation from dense and infer() {worst_tu:.3e}")
        del eng_t, e_tu, reqs_t, traces_t, t_fused, t_group, t_group_warm
    print(f"[tune] {card}: images/s (8 requests, {n_img} images, slots 4, "
          f"tile 8, device scheduling; runs in turns tuned, greedy, "
          f"greedy, tuned): " + ", ".join(
              f"{k} {' / '.join(f'{v:.3f}' for v in vs)}"
              for k, vs in ips.items()))

    # -- phase 3e: scale-out over a device mesh -------------------------------
    # One process drives the mesh; DeviceMesh.on lists this card four
    # times (JAX's forced host devices), so every shard's copy is a no-op
    # and its #1 launch goes to the same stream, in order.
    mesh = DeviceMesh.on("cuda:0", data=4)
    n_dcn = sum(isinstance(nd, DeformNode) for nd in graph.nodes)
    x4 = torch.as_tensor(images[:N_BATCH], device=dev)
    base_cfg = fx.GraphConfig(tile=8, schedule_backend="device")

    def graph_run(config, **kw):
        y, tr = fx.run_graph(params["convs"], graph, x4, config=config,
                             schedule_cache=ScheduleCache(),
                             return_trace=True, **kw)
        torch.cuda.synchronize()
        return y, tr

    y_one, tr_one = graph_run(base_cfg)

    def sharded_run(sub_mesh, sizes, what):
        """run_graph over ``sub_mesh``: bitwise the single-device run,
        its records and DRAM the simulator's; #1 once per non-empty
        shard and DCN segment."""
        reset_counts()
        kf.dcn_fused_batch_sharded.launches = 0
        calls = []
        with recording(kf, "_batch_call", calls):
            y, tr = graph_run(dataclasses.replace(base_cfg, mesh=sub_mesh),
                              shard_sizes=sizes)
        got = read_counts("dcn_fused_batch", "schedule_group_batch",
                          into={})
        d = sub_mesh.shape["data"]
        busy = (sum(s > 0 for s in sizes) if sizes is not None
                else min(N_BATCH, d))
        if not torch.equal(y, y_one):
            fail(f"{what}: sharded run_graph differs from the single-device "
                 f"run (max|d| {float((y - y_one).abs().max())})")
        if records(tr) != records(tr_one):
            fail(f"{what}: trace records differ from the single-device run")
        check_sim(what, [tr])
        if (tr.shards != d or tr.allgather_bytes != y.numel() * 4
                or kf.dcn_fused_batch_sharded.launches != busy * n_dcn
                or got["dcn_fused_batch"] != busy * n_dcn):
            fail(f"{what}: shards {tr.shards}, gathered "
                 f"{tr.allgather_bytes} B, #1 launched "
                 f"{kf.dcn_fused_batch_sharded.launches} times (wrapper "
                 f"count {got['dcn_fused_batch']}), expected {busy} x "
                 f"{n_dcn} DCN segments")
        print(f"[scale-out] {what}: run_graph of {N_BATCH} images == the "
              f"single-device run bitwise; records and DRAM == simulator; "
              f"shards {tr.shards}, {tr.allgather_bytes} B gathered; #1 "
              f"{kf.dcn_fused_batch_sharded.launches} launches ({busy} "
              f"shards x {n_dcn} DCN segments), the group launch "
              f"{got['schedule_group_batch']}")
        return calls

    shard_calls = sharded_run(mesh, [2, 1, 0, 1],
                              "DeviceMesh.on(cuda:0, 4), sizes [2, 1, 0, 1]")
    sharded_run(mesh, None, "DeviceMesh.on(cuda:0, 4), default split")
    # #1 per shard, held against its plain version and timed.
    by_shard, err_s = [], 0.0
    for a, _ in shard_calls:
        sdev, x_s, row_s, dep_s, cnt_s, idx_s, cf_s, w_s, b_s, t_s, ns = a
        got = kf._batch_call(*a)
        d, sc = rel_err(got, kf.dcn_fused_batch_plain(
            x_s, row_s, dep_s, cnt_s, idx_s, cf_s, w_s, b_s, t_in=t_s))
        torch.cuda.synchronize()
        if not d <= FUSED_RTOL * sc:
            fail(f"dcn_fused_batch (shard call): max|d|={d} > "
                 f"{FUSED_RTOL}*{sc}")
        err_s = max(err_s, d)
        by_shard.append(dict(
            rows=int(row_s.shape[0]), n_split=ns, device=str(sdev),
            ms=cuda_time_ms(lambda: kf._batch_call(*a), 20)))
    print(f"[scale-out] {card}: #1 per shard call (rows, n_split pinned "
          f"to the single call's {by_shard[0]['n_split']}): " + ", ".join(
              f"{r['rows']} rows {r['ms']:.4f} ms" for r in by_shard)
          + f"; the single-device call (phase 2): "
          f"{kernels['dcn_fused_batch']['ms']:.4f} ms; held within "
          f"{FUSED_RTOL}*max|ref| of the plain version")

    # The replica-aware engine: 8 slots, 2 a replica.
    eng_s = make_engine("device", slots=8, mesh=mesh)
    if eng_s.replicas != 4 or eng_s._slot_replica != [0, 0, 1, 1, 2, 2, 3,
                                                      3]:
        fail(f"engine replicas {eng_s.replicas}, slot map "
             f"{eng_s._slot_replica}")
    kf.dcn_fused_batch_sharded.launches = 0
    reqs_s, traces_s, wall_s = serve(eng_s)
    serve_launches = kf.dcn_fused_batch_sharded.launches
    no_ladder("scale-out serve", eng_s)
    bad = [r.rid for r in reqs_s if not r.done or r.error is not None]
    if bad:
        fail(f"scale-out serve: requests {bad} did not resolve cleanly")
    st_s = eng_s.stats                    # before infer() adds its images
    worst_s = max(max(check_logits(f"scale-out request {r.rid}", r.result(),
                                   dense_logits(images[ids])),
                      check_logits(f"scale-out request {r.rid} vs infer()",
                                   r.result(),
                                   eng_s.infer(images[ids]).cpu().numpy()))
                  for r, ids in zip(reqs_s, requests))
    check_sim("scale-out serve", traces_s)
    per_rep = [p["images"] for p in st_s["per_replica"]]
    if sum(per_rep) != st_s["images"] or st_s["allgather_bytes"] <= 0:
        fail(f"scale-out serve: per-replica images {per_rep} vs "
             f"{st_s['images']} served, {st_s['allgather_bytes']} B gathered")
    print(f"[scale-out] {card}: DcnServingEngine(slots=8) over "
          f"DeviceMesh.on(cuda:0, 4): {len(reqs_s)} requests, {n_img} "
          f"images in {len(traces_s)} steps; max rel. deviation from dense "
          f"and infer() {worst_s:.3e} (limit {LOGIT_RTOL}); every step == "
          f"simulator; per-replica images {per_rep} (warm-up included) sum "
          f"to {st_s['images']}; #1 {serve_launches} shard launches; "
          f"{st_s['allgather_bytes']} B gathered; no retry, no degraded "
          f"step")
    # images/s beside an unsharded engine of the same 8 slots, fresh
    # engines in turns (sharded, unsharded, unsharded, sharded).
    ips_s = {"sharded (4 replicas x 2 slots)": [n_img / wall_s],
             "unsharded (8 slots)": []}
    splits = {k: [] for k in ips_s}
    splits["sharded (4 replicas x 2 slots)"].append(
        host_split(traces_s, wall_s))
    del eng_s, reqs_s, traces_s
    for name, sub in (("unsharded (8 slots)", None),
                      ("unsharded (8 slots)", None),
                      ("sharded (4 replicas x 2 slots)", mesh)):
        e_turn = make_engine("device", slots=8, mesh=sub)
        _, tr_turn, w_turn = serve(e_turn)
        no_ladder(f"{name} serve", e_turn)
        ips_s[name].append(n_img / w_turn)
        splits[name].append(host_split(tr_turn, w_turn))
    # Where a sharded step's time goes (phase 4 profiles an unsharded one).
    profile_step(e_turn, images[12:16], card)
    no_ladder("profiled sharded step", e_turn)
    del e_turn, tr_turn
    print(f"[scale-out] {card}: images/s (8 requests, {n_img} images, "
          f"tile 8, device scheduling; in turns sharded, unsharded, "
          f"unsharded, sharded): " + ", ".join(
              f"{k} {' / '.join(f'{v:.3f}' for v in vs)}"
              for k, vs in ips_s.items())
          + f"; phase 3 (unsharded, 4 slots) {n_img / wall:.3f}")
    for k, vs in splits.items():
        print(f"[scale-out] {card}: {k}: " + " | ".join(vs))
    e_f, inj_f, rq_f, _ = fault_run(
        tag_ids, graph=fx.GraphConfig(tile=8, schedule_backend="device",
                                      mesh=mesh),
        kinds=("dispatch",), rate=1.0, max_fires=1, seed=3)
    failed = [r for r in rq_f if r.failed]
    st = e_f.stats
    if (inj_f.fired["dispatch"] != 1 or len(failed) != 1
            or not isinstance(failed[0].error, RequestFailedError)
            or not isinstance(failed[0].error.__cause__, FaultError)
            or (st["step_retries"], st["degraded_steps"]) != (1, 0)):
        fail(f"scale-out tagged fault: fired {inj_f.fired}, failed "
             f"{[repr(r.error) for r in failed]}, retries "
             f"{st['step_retries']}, degraded {st['degraded_steps']}")
    for r, i in zip(rq_f, tag_ids):
        if not r.failed:
            check_logits(f"scale-out step-mate {r.rid}", r.result(),
                         dense_logits(images[i:i + 1]))
    print(f"[scale-out] tagged dispatch fault on the sharded engine: "
          f"request {failed[0].rid} failed, its {len(rq_f) - 1} step-mates "
          f"served by the evicted retry (sharded); retries 1, degraded 0")
    del e_f
    kernels["dcn_fused_batch"]["sharded"] = dict(
        mesh="DeviceMesh.on(cuda:0, data=4)", sizes=[2, 1, 0, 1],
        launches=len(shard_calls), serve_launches=serve_launches,
        max_abs_err=err_s, by_shard=by_shard, images_per_s=ips_s)
    n_dev = torch.cuda.device_count()
    if n_dev >= 2:
        host_mesh = make_host_mesh(data=min(4, n_dev))
        calls = sharded_run(host_mesh, None,
                            f"make_host_mesh(data={min(4, n_dev)})")
        moved = sum(sum(t.numel() * t.element_size() for t in a[1:7])
                    + a[2].shape[0] * a[5].shape[1] * a[7].shape[2] * 4
                    for a, _ in calls if a[0] != x4.device)
        print(f"[scale-out] {card}: bytes copied between devices in that "
              f"run_graph (operands out, results back; weights once, not "
              f"counted): {moved}")
        kernels["dcn_fused_batch"]["sharded"]["cross_device_bytes"] = moved
    else:
        print(f"[scale-out] make_host_mesh sub-run needs 2 devices; this "
              f"host has {n_dev}: not run")

    # -- phase 4: where one serving step's time goes -------------------------
    profile_step(eng, images[12:16], card)
    no_ladder("profiled step", eng)
    del eng, host_eng, e_t, e_u

    # -- phases 5-7: the LM serving slice -------------------------------------
    lm_phases(card, kernels, launches, reset_counts)
    torch.cuda.empty_cache()

    # -- phases 8-9: training (no hand-written kernel has a backward) --------
    dcn_train_phase(card, wrappers)
    lm_train_phase(card, wrappers)

    # -- phase 10: the MoE / MLA families --------------------------------------
    moe_phases(card, kernels, wrappers, reset_counts, peak_bw)

    # -- phase 11: the recurrent families (Mamba, xLSTM) -----------------------
    recurrent_phases(card, kernels, wrappers, reset_counts, peak_bw)

    # -- phase 12: cross-attention (llama-3.2-vision-11b) ---------------------
    cross_phase(card, kernels, reset_counts, peak_bw)

    # -- phase 13: bf16 serving (#7 / #8 in bf16, llama in bf16) --------------
    bf16_phase(card, kernels, reset_counts, peak_bw)

    # -- phase 14: bf16 DCN serving (#1 / #4 / #5 in bf16, VGG19-3 in bf16) --
    dcn16 = dict(
        params=params, cfg=cfg, graph=graph, images=images,
        contraction=contraction, fused_ops=fused_ops, ops=[
            ("dcn_fused_batch", f"G={g_rows} P={p_pix} KK={kk} C={c_in} "
             f"O={c_out}", kf.dcn_fused_batch, kf.dcn_fused_batch_plain, a1,
             k1, (0, 6, 7), g_rows * p_pix, live1 * p_pix),
            ("dcn_fused_schedule", f"T={t4} P={p4} KK={w4.shape[0]} "
             f"C={w4.shape[1]} O={w4.shape[2]}", kf.dcn_fused_schedule,
             kf.dcn_fused_schedule_plain, a4, k4, (0, 5, 6), t4 * p4,
             live4 * p4),
            ("dcn_fused_tile", f"per tile S={x5t.shape[0]} "
             f"P={idx5t.shape[0]}", kf.dcn_fused_tile,
             kf.dcn_fused_tile_plain, a5t, k5t, (0, 3, 4), idx5t.shape[0],
             live5t),
            ("dcn_fused_tile", f"whole plane S={x5.shape[-2]} "
             f"P={idx5.shape[-3]}", kf.dcn_fused_tile,
             kf.dcn_fused_tile_plain, a5, k5, (0, 3, 4), idx5.shape[-3],
             live5)],
        bli=(bli_record, a6, a6x4, dcn_in, dcn_coords))
    bf16_ips = half_dcn_phase(card, kernels, reset_counts, dcn16,
                              torch.bfloat16)

    # -- phase 14c: a bf16 model over a float32 cache (#8 round_kv) ---------
    bf16_cache_phase()

    # -- phase 15: the mesh's "model" axis on this card -----------------------
    mesh_phase(card, reset_counts)

    # -- phase 16: training over the (data, model) mesh -------------------------
    mesh_train_phase(card, wrappers)

    # -- phase 17: the dry run beside the card ---------------------------------
    dryrun_phase(card)

    # -- phase 18: float16 (#1 / #4-#8), VGG19-3 and Qwen3-1.7B served in
    # float16, the general bodies of #7 / #8 -----------------------------------
    t18 = time.perf_counter()
    half_kernels(kernels, torch.float16, decode=F16_SIZES["decode"])
    fp16_bli(kernels, dcn16)
    print(f"[lm-fp16] 18a #6 / #7 / #8 took {time.perf_counter() - t18:.1f} "
          f"s")
    t0 = time.perf_counter()
    half_dcn_phase(card, kernels, reset_counts,
                   dict(dcn16, bf16_ips=bf16_ips), torch.float16)
    print(f"[dcn-fp16] 18a-b DCN took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fp16_lm_phase(card, kernels, reset_counts, peak_bw)
    print(f"[lm-fp16] 18c took {time.perf_counter() - t0:.1f} s")
    general_bodies_phase(card, kernels, launches)
    print(f"[fp16] phase 18 took {time.perf_counter() - t18:.1f} s")

    def bounds(kd):
        kd.update(bound_of(kd.pop("ops"), kd.pop("bytes")))
        if "fp32_ops" in kd:   # the same work on the FP32 CUDA cores
            kd["bound_fp32_ms"] = kd.pop("fp32_ops") / peak_fp32 * 1e3
        return "" if "bound_fp32_ms" not in kd else \
            f" (FP32 bound {kd['bound_fp32_ms']:.4f} ms)"

    out_k = []
    for name in [*wrappers, "flash_attention_any", "flash_decode_any"]:
        kd = kernels[name]
        fp32_note = bounds(kd)
        for shape_name, extra in {**kd.get("long_cache", {}),
                                  **kd.get("long_seq", {}),
                                  **kd.get("shapes", {}),
                                  **kd.get("bf16", {}),
                                  **kd.get("fp16", {})}.items():
            note = bounds(extra)
            runs = "" if "launches" not in extra else \
                f", {extra['launches']} launches on its path"
            f32 = "".join(f", {k.removesuffix('_ms')} {extra[k]:.4f} ms"
                          for k in ("f32_kernel_ms", "f32_cache_ms")
                          if k in extra)
            print(f"[kernel] {card}: {name} at {extra.pop('shape')}: "
                  f"{extra['ms']:.4f} ms (bound {extra['bound_ms']:.6f} ms "
                  f"by {extra['bound_by']} at {extra['bound_rate']}{note}, "
                  f"{100 * extra['bound_ms'] / extra['ms']:.1f} % of it, "
                  f"plain {extra['plain_ms']:.4f} ms, library "
                  f"{extra['library_ms']:.4f} ms{f32}){runs}")
        kd["launches"] = launches[name]
        shape = kd.pop("shape")
        lib_ms = kd["library_ms"]
        print(f"[kernel] {card}: {name} at {shape}: {kd['ms']:.4f} ms "
              f"(bound {kd['bound_ms']:.6f} ms by {kd['bound_by']} at "
              f"{kd['bound_rate']}{fp32_note}, "
              f"{100 * kd['bound_ms'] / kd['ms']:.1f} % of it, plain "
              f"{kd['plain_ms']:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}), "
              f"{kd['launches']} launches on its path")
        out_k.append({"name": name, **kd})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": out_k}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
