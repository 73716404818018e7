#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a card and ``nvcc``:

    python3 chip_smoke.py

Phases (one JSON line each, ``"phase"`` names them):

1. ``env``: the card, its power limit, torch and CUDA versions.  Without a
   card the script exits non-zero and prints no result.
2. ``build``: ``nvcc`` builds every kernel of the path from
   ``src/repro_torch/csrc`` for ``sm_90a``, with ``ptxas``'s register,
   shared-memory and spill lines.
3. ``kernels``: each kernel (decode_attention, rmsnorm, flash_attention,
   ssm_scan) against its plain PyTorch version on the card over the JAX
   package's test sweeps and the main paths' shapes (one line per case:
   error beside tolerance), then timed with CUDA events beside its plain
   version, one library call (where one exists) and its bound; rmsnorm
   also at the prefills' shapes, ssm_scan also launch by launch
   (``torch.profiler``).  The dense family's instances too: flash and
   decode attention at hd 256 (gemma3-1b, with and without its window of
   512), decode at G 5 and G 6 (qwen2.5-14b, nemotron-4-15b), rmsnorm at d
   1152 (rows instance), 5120 and 6144 (loop path), each timed with its
   ``ptxas`` lines.  And the serving families' (``serving_family_shapes``
   in the summary): flash non-causal at Sq != Sk (whisper's encoder and
   cross-attention, llama-3.2-vision's), causal at hd 112 G 8 (kimi-k2)
   and olmoe's; decode at olmoe's, kimi's and whisper's instances and the
   one-query cross-attention over 1500 and 1024 memory rows; rmsnorm at d
   768, 7168 and olmoe's q/k-norm rows.  Then flash_attention's
   compute-probability variant (``probs="compute"``, the
   ``flash_attention_compute`` entry of the summary) against its plain
   version over FLASH_COMPUTE_CASES (bf16 within 2e-2 and 1e-2
   row-relative, f32 within 2e-5), timed at qwen3-1.7b's prefill and
   gemma3-1b's local layer beside the float32 mode, SDPA and its bound.
4. ``geometry_*``: the chunk-geometry loop on the card
   (``repro_torch.core``).  ``geometry_sweep`` / ``geometry_winners``: the
   paper's sweep at its real size, ``sweep_scenarios`` over the six-replica
   FABRIC fleet and its Fig. 3 and Fig. 4 variants x the seven paper file
   sizes (1-64 GB) x the Table II grid x 32 seeds at jitter 0.02 (10,752
   lanes of 6 servers on the round engine), cold and warm, with the rounds
   run and the winner per scenario; ``geometry_card_vs_cpu``: the same code
   on the CPU over a subset (1 and 4 GB, 4 seeds), the same winners and
   times within rtol 1e-5; ``geometry_engines``: the event, round and scan
   engines at one 4 GB baseline point (round within 2% of event), with the
   round engine's device busy time; ``geometry_grad``:
   ``tune_chunk_params_grad`` and ``tune_chunk_params_mcgrad`` at 4 GB from
   the grid's winner (final gradient finite and nonzero, never worse than
   the grid).
5. ``restore`` / ``restore_tuned``: qwen3-1.7b at full width, random
   weights from a seeded ``torch.Generator`` on the card, saved with
   ``save_checkpoint`` and restored over MDTP from three throttled loopback
   mirrors (rates 1:2:4; the slowest is killed mid-restore) into device
   memory, every leaf checked bit for bit; then restored once more with a
   ``GridTuner`` on the card re-planning (C, L) from live telemetry
   (``restore_checkpoint(..., tuner=)``), bit-exact again, with at least
   one adopted geometry, beside the same tuner update timed alone.
   Then the same checkpoint through every tail option of
   ``restore_checkpoint``, every leaf bit-exact: ``restore_waves`` (four
   waves through a ``TransferManager``, the between-wave grid ``retune``
   on the card adopting a geometry at least once, the slowest mirror
   killed); ``restore_resume`` (a crash-resumable restore whose mirrors
   all stop at 40% of the blob must raise; over fresh mirrors it then
   fetches at most what its journal lacks, plus the manifest and one
   large chunk per range in flight, and retires journal and spool);
   ``restore_sharded_fetch`` (``fetch_sharded`` over K = 2 host sinks,
   host 0's origins at 1/4 of host 1's, stealing on: a steal from host
   0, every span byte-exact) and ``restore_sharded``
   (``shard_plan=(h, 2)`` for both hosts: disjoint leaves, together
   complete); ``restore_broadcast`` (two restores in two threads, B
   listing A's ``PeerMirror``: the peer served bytes, B's origins less
   than the blob); ``checkpoint_manager`` (``CheckpointManager`` saves
   the card's tree twice with keep 1; the kept step restores from disk).
6. ``serve``: ``generate`` with the restored weights (4 requests, 16 prompt
   + 32 generated tokens, greedy), every step a replay of the captured
   step (``serve.step.CapturedServeStep``): the launches captured per step
   held exact, one replay per position; then four teacher-forced steps of
   the kernel path against the plain path on the card.
7. ``dense_graph`` / ``profile``: the same ``generate`` with the step run
   eagerly: tokens identical, the captured step's teacher-forced logits
   within 1e-3 of the eager step's, ms per step of both, the replays'
   kernels counted by name in a profile and each path's device idle
   share (``profile``: the eager step's device time by kernel).
8. ``prefill``: qwen3-1.7b's full-sequence prefill (``make_prefill_step``)
   on the restored weights at B 4, S 2048: 28 flash_attention and 113
   rmsnorm launches per forward, exactly; the kernel path against the
   plain path (``hold_kernel_path``); time per prefill and a device
   profile.
9. ``hybrid_prefill`` / ``hybrid_generate``: zamba2-7b at full width and
   depth, random weights drawn on the card: prefill at B 1, S 4096 (13
   flash_attention, 81 ssm_scan, 108 rmsnorm launches per forward), held
   against the plain path; then ``generate`` at B 2, 16 + 16 tokens (13
   decode_attention launches per step), four teacher-forced steps held
   against the plain path, and the captured step against the eager one
   (``dense_graph``).
10. ``gemma3_prefill`` / ``gemma3_generate`` / ``gemma3_long_decode``:
   gemma3-1b at full width and depth (5:1 local / global, hd 256, window
   512), random weights on the card: prefill at B 1 x S 8192 (26
   flash_attention and 105 rmsnorm launches per forward; the reference's
   ``prefill_32k`` cut to 8192: the forward materialises [B, S, 262144]
   logits), held against the plain path at bf16 and f32; the captured
   ``generate`` at B 4, 600 + 32 tokens (26 decode_attention and 105
   rmsnorm launches per replay), four teacher-forced kernel-vs-plain steps
   from position 600, past the window; one captured step against a
   32768-key cache of random K / V at pos 32760 (the reference's
   ``decode_32k`` with its batch cut from 128 to 8), timed and held
   against the plain path.
11. ``dense_large_prefill`` / ``dense_large_generate``: qwen2.5-14b, then
   nemotron-4-15b, at full width and depth (29.54 and 31.26 GB of bf16
   weights drawn on the card): prefill at B 1 x S 4096 (L flash_attention,
   2 L + 1 rmsnorm launches per forward), held at bf16 and at f32 with the
   f32 weights upcast one layer at a time (the whole f32 copy would not
   fit beside the bf16 one); the captured ``generate`` at B 4, 16 + 16 (L
   decode_attention launches per replay) and four teacher-forced
   kernel-vs-plain steps.  Each model is freed before the next; each line
   prints its peak device memory.
12. ``xlstm_prefill`` / ``xlstm_generate``: xlstm-125m at full width and
   depth (6 x (mLSTM, sLSTM), d 768), its zero-init ``b_if`` and ``b``
   set nonzero: prefill at B 1 x S 256 (13 rmsnorm launches per forward,
   no other kernel: the cells' loops over time are host-bound), held at
   bf16 and f32; the captured ``generate`` at B 4, 16 + 32; one captured
   step at position 524,287 (the reference's ``long_500k``; the state has
   no sequence axis), held against the plain path.
13. ``moe_prefill`` / ``moe_generate``: olmoe-1b-7b at full width and
   depth (16 layers, E 64, top 8, qk-norm): prefill at B 1 x S 4096 (16
   flash_attention, 65 rmsnorm launches per forward), held at bf16 and
   with the whole model in f32; the captured ``generate`` at B 4, 16 + 16
   (16 decode_attention per replay; capacity 1 per expert); the dropped
   (token, slot) pairs of every hold run printed, equal on the f32 kernel
   and plain paths.
14. ``moe_kimi_layer``: kimi-k2 at full width (d 7168, E 384, top 8, H 64
   / KV 8, hd 112, vocab 163,840) with ``n_layers`` cut 61 -> 1 (36.4 GB
   of the model's 2.08 TB): prefill at B 1 x S 2048, the captured step at
   B 4, 16 + 16.  No f32 copy fits beside the bf16 one, so the holds are
   bf16 at the decode-step tolerance with the kernel path routed as the
   plain path chose (``MoEProbe``): a reordered near-tie between two
   experts is not a kernel fault; the reordered choices are counted.
15. ``encdec_prefill`` / ``encdec_generate``: whisper-large-v3 at full
   size (32 + 32 layers, d 1280, H 20, hd 64, LayerNorm, GELU), its
   LayerNorm biases set nonzero: prefill over B 1 x 1500 frames and 448
   tokens (96 flash_attention launches: 32 bidirectional 1500 x 1500, 32
   causal, 32 cross 448 x 1500).  The plain hold's attention takes each
   sequence as one query block (``q_block`` 1500): the reference's blocked
   form needs a length that is a multiple of its 1024-query block, which
   1500 is not (the kernel path has no such limit).  Then the captured
   ``generate`` at B 4, 16 + 32 against the model's own encoder output
   over 4 x 1500 frames (64 decode_attention per replay: 32 self, 32
   one-query cross).
16. ``vlm_prefill`` / ``vlm_generate``: llama-3.2-vision-11b at full size
   (8 x (4 attn + 1 gated cross-attention), d 4096, H 32 / KV 8), its
   gates set to 0.5 (``tanh(0) = 0`` would add no cross-attention):
   prefill over B 1 x 1024 patches and S 2048 (40 flash_attention: 32
   causal, 8 cross at 2048 x 1024), the f32 hold upcast one group at a
   time; the captured ``generate`` at B 4, 16 + 16 against the 1024
   projected patches (40 decode_attention per replay).

17. ``train_grad_hold``: gradients through the kernels (each launch in
   an ``autograd.Function`` whose backward is the plain version's VJP)
   against the plain path's, on the card.  Per kernel at the training
   path's shapes: flash_attention causal at qwen3's (B 4 x S 2048, H 16 /
   KV 8, hd 128), windowed at gemma3's (hd 256, window 512) and
   non-causal at whisper's 448 x 1500 cross-attention; rmsnorm with and
   without residual at (8192, 2048) and qwen3's q/k-norm rows (65536,
   128); ssm_scan at zamba2's H 112, P = N = 64.  Per model: every
   leaf's gradient of ``lm_loss`` for qwen3-1.7b at full width with 2
   layers and zamba2-7b at full width with one hybrid period (6 Mamba2
   blocks + the shared attention), B 2 x S 1024, under the configs'
   ``remat="full"`` (each kernel of the stack launches twice: forward
   and recompute; held exact).  f32 within atol = rtol = 1e-2 and at
   cosine > 0.9999; bf16 within twice the plain path's own distance from
   f32.  Each kernel's forward + backward timed beside the plain path's
   and a library call's (SDPA, ``F.rms_norm``).
18. ``train``: qwen3-1.7b at full size (28 layers, ``remat="full"``)
   trains from the restored weights through ``launch.train.run_training``
   (``MultiSourcePipeline`` over three throttled loopback mirrors, B 4 x
   S 2048), TRAIN_STEPS steps: every loss finite, launches per step exact
   (56 flash_attention, 225 rmsnorm); ms per step, tokens/s, model
   TFLOP/s (6 N T) against the 989 TFLOP/s bf16 peak, peak device
   memory, the device idle share and top kernels of one profiled step,
   and the device time under each kernel's plain-VJP backward; then
   TRAIN_REPEAT steps on one batch, whose last loss must be below its
   first.
19. ``train_resume``: qwen3-1.7b at full width with 2 layers, 4 steps
   with ``CheckpointManager(every_steps=2)``; the step-2 state restored
   onto the card by ``restore_checkpoint`` bit-exact to the saved one;
   steps 2-3 re-run from it within 1e-3 relative of the uninterrupted
   run's losses (deterministic algorithms on, warn-only; whether they are
   bit-equal is printed).
20. The distributed phase (``repro_torch.distributed``), under a 1-rank
   NCCL process group in this process (``file://`` rendezvous) and a
   (1, 1) (data, model) mesh from ``launch.mesh.make_local_mesh``.
   ``restore_dtensor`` (run at the end of the restore options, while
   their checkpoint is on disk): qwen3-1.7b restored over the three
   mirrors with ``shardings=sharding_tree(...)``, every leaf a
   ``DTensor`` whose local shard is bit-exact to the saved leaf.
   ``dist_qwen3_dp``: qwen3-1.7b at full width with 2 layers, two AdamW
   steps under the mesh and two without, from one seed: losses and
   parameters bit-equal.  ``dist_olmoe_hold``: olmoe-1b-7b at full width
   with 2 layers at capacity factor 64, the a2a path at M = 1 against the
   one-hot path (no pair dropped; loss and router gradients within the
   stated bf16 tolerance).  ``dist_olmoe_train``: olmoe-1b-7b at full
   width with 8 of its 16 layers (3.56 B parameters), B 4 x S 2048, three
   timed steps and one profiled step through each path (ms per step,
   tokens/s, peak memory, idle share, dropped pairs in one forward,
   launches exact).  ``dist_compression``: ``compressed_mean`` and
   ``compressed_reduce_scatter`` over a qwen3 gradient tree, bit-equal to
   the CPU's arithmetic.  ``dist_gloo_two_ranks``: two gloo ranks spawned
   on the card (CUDA tensors), each with 32 of olmoe's experts, the MoE
   block's outputs and gradients against this process's 1-rank run.
   ``dist_tp_qwen3``: qwen3-1.7b at full width with TP_LAYERS of its 28
   layers under ``launch.dryrun.rules_for``, tensor parallel over two
   gloo ranks on
   the card (a (1, 2) mesh: 8 of 16 query heads, 4 of 8 KV heads, 3,072
   of 6,144 MLP columns, 75,968 of 151,936 vocabulary rows and the
   vocab-parallel loss each), TP_STEPS steps of B 2 x S 2048 at bf16 and
   of B 2 x S 512 at f32 with 2 layers, against this process's run of
   the same batches on the 1-rank mesh: losses, step 0's gradient of
   every leaf on each rank's block, launches exact on both ranks; ms a
   step and peak memory per rank (gloo through the host, not NVLink).
   ``dist_zero1_save``: four gloo ranks on a (2, 2) mesh, qwen3-1.7b at
   full width with ZERO1_LAYERS layers, with ZeRO-1 moments
   (``opt_rules_for``) and without: parameters bit-equal, moments halved,
   the ZeRO-1 state saved through ``CheckpointManager(shardings=)``
   byte-identical to this process's whole-state save of the blocks
   assembled, and restored bit-exact through
   ``restore_checkpoint(shardings=)`` on the (1, 1) mesh.
21. Decode under a mesh (``launch.dryrun.serve_rules``), last in the
   distributed phase.  ``serve_graph_mesh``: qwen3-1.7b's captured step
   under the rules on the 1-rank NCCL mesh, tokens equal to the eager
   step's with and without the mesh.  ``dist_decode_qwen3``: qwen3-1.7b
   at full width and depth on four gloo ranks of a (2, 2) mesh, B 1 over
   32768 keys (split by sequence over ``data``: each rank attends over its
   block through ``decode_attention_partials``, the ranks all-gather the
   partials and merge them with ``decode_attention_merge``) and B 4 (split
   by batch), DECODE_STEPS steps from a cache whose earlier keys are
   seeded random K / V; ``dist_decode_gemma3`` (B 4 over 1024 keys split
   by sequence over ``model``, the window of 512 across the boundary) and
   ``dist_decode_olmoe`` (32 of 64 experts a rank, the one-hot MoE path
   across ranks) on two ranks of (1, 2).  Each against this process's
   one-rank runs of the same weights and cache: f32 greedy tokens equal
   and logits within DECODE_F32_TOL; bf16 teacher-forced, within
   DECODE_BF16_FACTOR times the one-rank bf16 run's distance from f32
   (olmoe's bf16 run reported, not held: its router reorders near-tied
   experts); launches a step exact; ms a step and peak a rank.  The bf16
   limit is read against a fault (DECODE_FAULTS): qwen3's B 1 run again
   with block 1 of the keys left out of every merge must exceed it.  The
   kernel phase holds the partials mode on 2 and 4 blocks
   against the whole-cache kernel and the plain version
   (``decode_partials_phase``; bf16 within one bf16 ulp of the largest
   entry, PARTIALS_BF16_REL), and checks that the hold fails when the
   block holding ``pos`` is left out of the merge.
22. The hybrid and xLSTM families under a mesh, last in the distributed
   phase, on two gloo ranks spawned once (``--gloo-program recurrent``).
   ``dist_tp_zamba2``: zamba2-7b at full width with 7 of its 81 layers
   (one hybrid group and one tail Mamba2 block), tensor parallel on (1,
   2) under ``rules_for`` (56 of 112 SSM heads a rank, ``w_in``'s storage
   block multiplied and the projection gathered, the gated norm's sum of
   squares all-reduced, the shared block's heads and MLP, the vocabulary),
   TP_STEPS steps of B 1 x S 2048 at bf16 and of B 1 x S 512 at f32;
   ``dist_tp_xlstm``: xlstm-125m at full width with 4 of its 12 layers
   (the mLSTM's ``d_in`` over ``model``), B 2 x S 64 at bf16, 2 layers at
   f32; each against this
   process's run of the same batches on the 1-rank mesh, as
   ``dist_tp_qwen3`` holds it.  ``dist_decode_zamba2`` /
   ``dist_decode_xlstm``: the same depths under ``serve_rules`` on (1, 2)
   and on (2, 1) (the batch rows and their recurrent states over
   ``data``), B 4, DECODE_STEPS steps, f32 and bf16, held as
   ``dist_decode_phase`` holds its runs; each rank's cache bytes beside
   the whole cache's.
23. The encdec and vlm families under a mesh, last in the distributed
   phase (``dist_cross_phase``).  ``dist_tp_whisper``: whisper-large-v3
   at full width with 2 + 2 of its 32 + 32 layers on four gloo ranks of a
   (2, 2) mesh (``--gloo-program cross4``) under ``rules_for``: its FSDP
   storage puts every ``d`` dim over ``data`` (``frontend_proj`` and the
   encoder's final norm too, gathered before use and again in the
   recompute), heads, MLP and vocabulary over ``model``; B 2 x 448 tokens
   over 1500 frames at bf16, 2 + 2 layers and 128 tokens at f32.
   ``dist_tp_llama_vision``: llama-3.2-vision-11b at full width with 5 of
   its 40 layers (4 self-attention, 1 gated cross-attention; 2.1 B
   parameters) on two ranks of (1, 2) (``--gloo-program cross2``), B 1 x
   S 2048 over 1024 patches at bf16, 2 layers with ``cross_attn_period``
   2 at f32.  Each against this process's run on the 1-rank NCCL mesh, as
   ``dist_tp_zamba2``.  ``dist_decode_whisper`` /
   ``dist_decode_llama_vision``: the same depths under ``serve_rules`` on
   (1, 2) and (2, 1), B 4 against the model's own memory (the encoder over
   1500 frames, 1024 projected patches), of which each rank's cache holds
   its batch rows, DECODE_STEPS steps to 448 and 2048 keys, f32 and bf16,
   held as ``dist_decode_phase`` holds its runs; each rank's memory and
   KV bytes must be its block's.
24. The multi-pod production layout, last in the distributed phase
   (``dist_multipod_phase``, ``--gloo-program multipod``): four gloo
   ranks spawned once build two ``(pod, data, model)`` meshes and run
   under ``rules_for(cfg, multi_pod=True)`` with ZeRO-1 moments
   (``opt_rules_for(..., True)``), whose data axes ``("data", "pod")``
   are out of mesh order (data-major, as JAX lays them out).
   ``dist_multipod_olmoe_221``: olmoe-1b-7b at full width with 1 of its
   16 layers on (2, 2, 1), its experts stored over ``("data", "pod")``
   and gathered by the a2a path at M 1, B 4 x S 2048 at bf16 (2 steps)
   and B 4 x S 512 at f32 (1 step); ``dist_multipod_whisper_221``:
   whisper-large-v3 at full width with 2 + 2 layers on (2, 2, 1), its
   ``d`` dims over ``("data", "pod")``, B 4 x 448 tokens over 1500
   frames at bf16; ``dist_multipod_olmoe_212``: olmoe on (2, 1, 2) at B
   2 x S 2047 (bf16) and 2 x 511 (f32), where M does not divide S, so
   the MoE block trains through the one-hot path across ranks.  Each
   against this process's run on the 1-rank NCCL mesh as
   ``dist_tp_zamba2``, the MoE runs routed as that run routed
   (``MoEProbe``'s replay, flips counted), each rank's parameter and moment
   blocks checked against the data-major blocks of their specs.
   ``dist_multipod_save``: the olmoe bf16 ZeRO-1 state saved sharded,
   byte-identical to this process's save of the assembled state, and
   restored with ``shardings=`` onto the mesh, bit-exact, two ranks at a
   time.
   ``dist_multipod_decode``: olmoe decode under
   ``serve_rules(multi_pod=True)`` on (2, 2, 1), B 4, f32 and bf16, held
   as ``dist_decode_phase`` holds its runs.  ``dist_multipod``: the
   phase's seconds.
25. ``compute_probs_prefill`` / ``compute_probs_step`` (run after
   ``prefill``, on the restored weights): qwen3-1.7b at full width and
   depth under ``attn_probs_dtype="compute"``.  The prefill at B 4 x S
   2048 through the kernels (28 launches of the compute variant per
   forward, exactly) held against the plain compute path by
   ``hold_kernel_path``; one train step (``lm_loss`` and its gradients,
   ``remat="full"``) at B 4 x S 2048, its loss within COMPUTE_LOSS_RTOL
   of the plain compute path's and its gradient's distance from the f32
   gradient within twice the plain path's.  Printed, not held: the
   logits' distance from the float32 mode's and both modes' ms.
26. ``examples`` (run after ``train_resume``): the four entry points of
   ``repro_torch.examples`` on the card, in this process: quickstart;
   multisource_restore onto the card, bit-exact; autotune_chunks on the
   card and on the CPU, the same winners; train_100m for
   EXAMPLE_TRAIN_STEPS steps (its loss trends down), its first loss
   against the plain path's on the same weights and batch.

Then the ``{"kernels": [...]}`` summary, the card's name and power limit as
``nvidia-smi`` reports them, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
those lines.

``python3 chip_smoke.py --rmsnorm-only --src OTHER/src`` builds another
checkout's kernels and prints only rmsnorm's timing lines: run it for two
checkouts in turns, in one call, to compare their kernels on one card.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import nullcontext

ROOT = os.path.dirname(os.path.abspath(__file__))
MB = 1 << 20
T0 = time.perf_counter()

#: published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, dense
#: bf16 tensor-core and f32 (non-tensor) flop/s
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

#: tolerances of the JAX package's kernel tests, per dtype
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

#: the slowest mirror's rate (the others run 2x and 4x), chosen so the three
#: together stay below what one host's loopback sustains and the mirrors,
#: not the sockets, set each one's share; the slowest dies once it has
#: served this many bytes (about a second of its share), mid-restore
MIRROR_RATE = 64 * MB
KILL_AT_BYTES = 64 * MB


#: (batch, sequence) of the qwen3-1.7b prefill and the zamba2-7b prefill
PREFILL_SHAPE = (4, 2048)
HYBRID_SHAPE = (1, 4096)

#: rmsnorm's shapes on the main paths: qwen3-1.7b decode (ln, q-norm,
#: k-norm at B 4) and prefill (B 4 x S 2048), zamba2-7b prefill (S 4096)
#: and generate (B 2); d 3584 is 14 16-byte vectors a lane at bf16
RMSNORM_PATH_SHAPES = [(4, 1, 2048), (4, 1, 16, 128), (4, 1, 8, 128),
                       (4, 2048, 2048), (4, 2048, 16, 128), (4, 2048, 8, 128),
                       (1, 4096, 3584), (2, 1, 3584),
                       # gemma3-1b prefill (S 8192) and decode (B 4 and 8):
                       # d 1152 and the q/k-norm's 256; qwen2.5-14b and
                       # nemotron-4-15b prefill (S 4096) and decode (B 4)
                       (1, 8192, 1152), (1, 8192, 4, 256), (1, 8192, 1, 256),
                       (4, 1, 1152), (4, 1, 4, 256), (8, 1, 1, 256),
                       (1, 4096, 5120), (4, 1, 5120), (1, 4096, 6144),
                       (4, 1, 6144),
                       # xlstm-125m (d 768) prefill and decode; olmoe-1b-7b
                       # (d 2048, q/k-norm of 16 heads of 128) at S 4096
                       # and B 4; kimi-k2 (d 7168); llama-3.2-vision (d
                       # 4096) at S 2048 and B 4
                       (1, 2048, 768), (4, 1, 768), (1, 4096, 2048),
                       (1, 4096, 16, 128), (4, 1, 16, 128),
                       (1, 2048, 7168), (4, 1, 7168), (1, 2048, 4096),
                       (4, 1, 4096)]

#: rmsnorm's timing shapes, bf16: decode (qwen3 B 4 x d 2048, the heads'
#: q/k-norm), then every call shape of the prefills, where its time is
#: spent: qwen3 (B 4 x S 2048 rows of d 2048, the q-norm's 131072 rows of
#: 128 and the k-norm's 65536) and zamba2 (4096 rows of d 3584)
RMSNORM_TIME_SHAPES = ((4, 2048), (64, 128), (8192, 2048), (131072, 128),
                       (65536, 128), (4096, 3584))
#: ragged row counts on the persistent path: rows that fill no whole step
#: of a warp, the last warps' steps cut short, a single row
RMSNORM_RAGGED_SHAPES = [(131071, 128), (4097, 3584), (1, 2048)]
#: rmsnorm timed at the dense family's widths, bf16: gemma3's d 1152 on the
#: (16, 9) rows instance (prefill rows, decode rows), qwen2.5's 5120 and
#: nemotron's 6144 on the loop path (prefill rows, decode rows)
RMSNORM_FAMILY_SHAPES = ((8192, 1152), (4, 1152), (4096, 5120), (4, 5120),
                         (4096, 6144), (4, 6144))
#: rmsnorm timed at the serving families' widths, bf16: xlstm-125m's d 768
#: (prefill rows, decode rows), olmoe-1b-7b's q/k-norm (B 1 x S 4096 x 16
#: heads of 128), kimi-k2's d 7168 (prefill rows, decode rows)
RMSNORM_SERVING_SHAPES = ((2048, 768), (4, 768), (65536, 128), (2048, 7168),
                          (4, 7168))
#: the L2 cache of an H100 (50 MB): a cold timing rotates over enough
#: distinct inputs and outputs that each call finds its x evicted
L2_BYTES = 50 * 10**6

#: flash_attention at bf16: the largest per-row relative error,
#: |out - ref| / |ref| over each query row's head vector.  bf16 rounding of
#: the output and of the plain path's probabilities gives ~2e-3; the
#: element-wise 2e-2 of the JAX tests is loose where outputs are small, as
#: they are at the main paths' lengths (|o| ~ 0.03 at S 2048)
FLASH_BF16_ROW_REL_TOL = 1e-2

#: the port's kernels, by wrapper name
KERNELS = ("decode_attention", "rmsnorm", "flash_attention", "ssm_scan")
#: launch counts of kernel variants that share a wrapper: the summary's
#: name -> (wrapper, its counter).  flash_attention's compute-probability
#: instances (``probs="compute"`` at bf16) count apart from its launches
VARIANTS = {"flash_attention_compute": ("flash_attention",
                                        "compute_launches")}

#: the dense family's paths: gemma3-1b prefill (S 8192, the reference's
#: ``prefill_32k`` cut: the forward materialises [B, S, 262144] logits) and
#: generate (B 4, a 600-token prompt so that the local layers' windows of
#: 512 cut the last ~120 steps, 32 generated); its long step (the
#: reference's ``decode_32k``, batch cut from 128 to 8); qwen2.5-14b and
#: nemotron-4-15b prefill (B 1 x S 4096) and generate (B 4, 16 + 16)
GEMMA3_PREFILL_SHAPE = (1, 8192)
GEMMA3_GENERATE = (4, 600, 32)
GEMMA3_LONG = (8, 32768, 32760)
LARGE_PREFILL_SHAPE = (1, 4096)
LARGE_GENERATE = (4, 16, 16)
#: the captured step against the eager one, teacher-forced logits
GRAPH_ATOL = 1e-3
#: the serving families' paths: xlstm-125m prefill (B 1 x S 2048),
#: generate (B 4, 16 + 32) and one step at the reference's long_500k
#: position (B 1); olmoe-1b-7b prefill (B 1 x S 4096) and generate (B 4, 16
#: + 16); one full-width kimi-k2 layer, prefill (B 1 x S 2048) and generate
#: (B 4, 16 + 16); whisper-large-v3 over 1500 frames (its encoder's native
#: 30 s grid) and 448 tokens (its decoder's limit), generate (B 4, 16 + 32)
#: against its own encoder output; llama-3.2-vision-11b over 1024 patches
#: and S 2048, generate (B 4, 16 + 16) against the projected patches
#: S 2048 -> 512 once the encdec and vlm phases joined the script, 512 ->
#: 256 once the multi-pod phase did (the time limit): the prefill's time
#: loop is host-bound, 11.1 s at 2048
XLSTM_PREFILL_SHAPE = (1, 256)
XLSTM_GENERATE = (4, 16, 32)
XLSTM_LONG_POS = 524_287
#: the xlstm prefill's device profile covers this many positions (its
#: loops over time issue ~260 kernels a position; a trace of all 2048
#: takes minutes to read), scaled to the whole prefill; 256 -> 64 once
#: the multi-pod phase joined the script (the time limit)
XLSTM_PROFILE_SEQ = 64
MOE_PREFILL_SHAPE = (1, 4096)
MOE_GENERATE = (4, 16, 16)
KIMI_LAYERS = 1
KIMI_PREFILL_SHAPE = (1, 2048)
KIMI_GENERATE = (4, 16, 16)
WHISPER_FRAMES = 1500
WHISPER_TOKENS = 448
ENCDEC_GENERATE = (4, 16, 32)
VLM_PATCHES = 1024
VLM_PREFILL_SHAPE = (1, 2048)
VLM_GENERATE = (4, 16, 16)
#: the value each zero-init cross-attention gate is set to (tanh 0.46)
GATE_VALUE = 0.5
#: training: each kernel's gradient at the training path's shapes (flash:
#: qwen3 causal B 4 x S 2048, H 16 / KV 8, hd 128; gemma3's window of 512
#: at hd 256; whisper's 448 x 1500 cross-attention; rmsnorm at d 2048 and
#: qwen3's q/k-norm rows; ssm_scan at zamba2's H 112, P = N = 64), then
#: whole models' per-leaf gradients (qwen3-1.7b at full width with 2
#: layers, zamba2-7b at full width with one hybrid period) at B 2 x S 1024
GRAD_FLASH_SHAPES = (  # label, B, Sq, Sk, H, KV, hd, causal, window
    ("qwen3 causal", 4, 2048, 2048, 16, 8, 128, True, None),
    ("gemma3 local", 1, 2048, 2048, 4, 1, 256, True, 512),
    ("whisper cross", 2, 448, 1500, 20, 20, 64, False, None),
)
GRAD_RMSNORM_SHAPES = ((8192, 2048), (65536, 128))
GRAD_SSM_SHAPE = (1, 2048, 112, 64, 64)
GRAD_MODEL_SHAPE = (2, 1024)
GRAD_MODEL_LAYERS = 2
#: qwen3-1.7b trained at full size: B 4 x S 2048 batches from the
#: pipeline over three loopback mirrors, TRAIN_STEPS steps (10 until the
#: multi-pod phase joined the script: the time limit), then
#: TRAIN_REPEAT steps on one batch (its loss must fall)
TRAIN_SHAPE = (4, 2048)
TRAIN_STEPS = 6
TRAIN_REPEAT = 4
#: train_resume: qwen3-1.7b at full width with 2 layers, B 2 x S 1024
RESUME_SHAPE = (2, 1024)
#: H100 SXM dense bf16 peak (NVIDIA's H100 datasheet)
BF16_PEAK = 989e12
#: compute_probs: qwen3-1.7b at full width and depth under
#: attn_probs_dtype="compute", the prefill at PREFILL_SHAPE and one train
#: step at TRAIN_SHAPE; the step's loss within COMPUTE_LOSS_RTOL of the
#: plain compute path's (TP_LOSS_RTOL's limit for bf16 losses)
COMPUTE_SEED = 37
COMPUTE_LOSS_RTOL = 2e-3
#: examples: train_100m's steps on the card, the example's default (the
#: reference asserts its loss trend from 10 steps on; at 12 the cosine
#: schedule decays before the loss moves, and on an H100 the last three
#: losses' mean stayed above the first three's); its first loss against
#: the plain path's within COMPUTE_LOSS_RTOL
EXAMPLE_TRAIN_STEPS = 30


class CheckFailed(Exception):
    pass


def emit(phase: str, **kw) -> None:
    """One JSON line; ``at_s``: seconds since the script started (where
    the time limit goes)."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - T0}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(torch, fn, iters: int) -> tuple[float, float]:
    """(graph_ms, eager_ms) per call of ``fn``.  graph_ms replays ``iters``
    calls captured in one CUDA graph, so the host's launch overhead drops
    out and what is left is device time; eager_ms issues the same calls back
    to back from Python, as the serving loop does.  Both with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(run) -> float:
        torch.cuda.synchronize()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    graph_ms = timed(graph.replay)
    del graph

    def eager():
        for _ in range(iters):
            fn()

    return graph_ms, timed(eager)


def dev_us(e) -> float:
    """Device microseconds of one ``torch.profiler`` key-average entry."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def kernel_times_by_name(torch, fn, reps: int, needle: str) -> dict:
    """Device ms per call of ``fn`` of each kernel whose name holds
    ``needle`` (``torch.profiler`` over ``reps`` calls after a warm-up)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(rf"({needle}\w*_kernel)", e.key)
        if m and str(getattr(e, "device_type", "")).endswith("CUDA"):
            out[m.group(1)] = out.get(m.group(1), 0.0) + dev_us(e) / reps / 1e3
    return out


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------------ kernels

def ptxas_of(ptxas, name: str) -> list:
    """``ptxas``'s register / shared-memory / spill lines of every instance
    of one kernel (its merge kernel included)."""
    return [ln for ln in ptxas if ln.startswith(name)]


def kernel_phase(torch, K, dev, ptxas):
    """Sweeps and timings of every kernel.  Returns the summary entries
    (launch counts are filled in after the main path's run)."""
    import torch.nn.functional as F

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dtypes[dt])

    # worst error per kernel and dtype, each beside its dtype's tolerance
    worst = {name: dict.fromkeys(dtypes, 0.0)
             for name in ("decode_attention", "rmsnorm", "flash_attention",
                          "flash_attention_compute", "ssm_scan")}

    def record(name, label, dt, out, ref, tols=TOL):
        err = (out.float() - ref.float()).abs().max().item()
        tol = tols[dt]
        ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
        print(json.dumps({"case": f"{name} {dt} {label}", "max_abs_err": err,
                          "tol": tol, "ok": ok}), flush=True)
        check(ok, f"{name} {dt} {label}: max abs err {err} over tol {tol}")
        worst[name][dt] = max(worst[name][dt], err)

    # decode attention: the JAX sweep (tests/test_kernels_decode_ssm.py),
    # then the main paths' shapes (qwen3 serve, zamba2 generate) and the
    # timing shape
    dcases = ([(2, 2, 4, hd, 512, 300, None) for hd in (64, 112, 128)]
              + [(2, 2, g, 64, 512, 511, None) for g in (1, 2, 8)]
              + [(2, 2, 4, 64, 512, p, None) for p in (0, 1, 255, 256, 500)]
              + [(2, 2, 4, 64, 1024, 900, w) for w in (None, 32, 256, 1 << 20)]
              + [(2, 2, 4, 64, 700, 600, None),
                 (4, 8, 2, 128, 48, 47, None),
                 (4, 8, 2, 128, 4096, 4095, None)]
              + [(2, 32, 1, 112, 32, p, None) for p in (0, 15, 31)]
              # the timing shape's cache cut into slices across blocks:
              # empty, partial and full slices, windows inside one slice
              # and across two
              + [(4, 8, 2, 128, 4096, p, None) for p in (0, 1, 300, 2047, 4095)]
              + [(4, 8, 2, 128, 4096, p, w) for p in (2047, 4095)
                 for w in (32, 256)]
              # hd 256 at gemma3's G 4, KV 1 (serving cache and the long
              # step's 32768 keys, with and without its window of 512),
              # and G 5 (qwen2.5) and G 6 (nemotron) at hd 128
              + [(4, 1, 4, 256, 632, p, w) for p in (100, 631)
                 for w in (None, 512)]
              + [(8, 1, 4, 256, 32768, 32760, w) for w in (None, 512)]
              + [(2, 2, 2, 256, 512, 300, None)]
              + [(4, 8, g, 128, S, S - 1, None) for g in (5, 6)
                 for S in (32, 4096)]
              + [(4, 8, 6, 128, 4096, 2047, 256)]
              # the serving families' generate at B 4: olmoe (KV 16, G 1,
              # hd 128), kimi-k2 (KV 8, G 8, hd 112), whisper's decoder
              # (KV 20, G 1, hd 64), and the one-query cross-attention over
              # whisper's 1500 encoder rows and llama-3.2-vision's 1024
              # patches (pos = M - 1)
              + [(4, 16, 1, 128, 32, p, None) for p in (0, 31)]
              + [(4, 8, 8, 112, 32, p, None) for p in (0, 31)]
              + [(4, 20, 1, 64, 48, p, None) for p in (0, 47)]
              + [(4, 20, 1, 64, 1500, 1499, None),
                 (4, 8, 4, 128, 1024, 1023, None)])
    for dt in dtypes:
        for B, KV, G, hd, S, pos, win in dcases:
            q = randn((B, 1, KV * G, hd), dt)
            k, v = randn((B, S, KV, hd), dt), randn((B, S, KV, hd), dt)
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            out = K.decode_attention(q, k, v, p, window=win)
            ref = K.decode_attention_plain(q, k, v, p, window=win)
            torch.cuda.synchronize()
            record("decode_attention",
                   f"B{B} KV{KV} G{G} hd{hd} S{S} pos{pos} window{win}",
                   dt, out, ref)

    # rmsnorm: the JAX sweep (tests/test_kernels.py), a width with no
    # 16-byte access and ragged row counts, with and without the fused
    # residual; then the main paths' shapes (RMSNORM_PATH_SHAPES) at both
    # dtypes the paths run, scale in x's dtype as the models hold it
    rshapes = [(64, 256), (3, 7, 512), (1000, 128), (4, 2048), (5, 130)]
    for dt in dtypes:
        for shape in rshapes + RMSNORM_RAGGED_SHAPES:
            for with_res in (False, True):
                x = randn(shape, dt)
                s = randn(shape[-1:], "float32") * 0.1 + 1.0
                r = randn(shape, dt) if with_res else None
                out, ref = K.rmsnorm(x, s, r), K.rmsnorm_plain(x, s, r)
                torch.cuda.synchronize()
                record("rmsnorm", f"{shape} residual={with_res}", dt, out, ref)
    for dt in dtypes:
        for shape in RMSNORM_PATH_SHAPES:
            x, s = randn(shape, dt), randn(shape[-1:], dt)
            out, ref = K.rmsnorm(x, s), K.rmsnorm_plain(x, s)
            torch.cuda.synchronize()
            record("rmsnorm", f"{shape} main-path", dt, out, ref)
            del x, out, ref

    # timings at the slice's shapes, bf16.  The decode caches (67 MB of
    # K+V) exceed the 50 MB L2, as each layer's cache does on the path.
    B, KV, G, hd, S, pos = 4, 8, 2, 128, 4096, 4095
    H, e = KV * G, 2
    q = randn((B, 1, H, hd), "bfloat16")
    k, v = randn((B, S, KV, hd), "bfloat16"), randn((B, S, KV, hd), "bfloat16")
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(hd)
    qs = q.transpose(1, 2)
    ks, vs = k[:, :pos + 1].transpose(1, 2), v[:, :pos + 1].transpose(1, 2)
    d_ms, d_eager = cuda_time_ms(torch, lambda: K.decode_attention(q, k, v, p),
                                 100)
    d_plain, _ = cuda_time_ms(
        torch, lambda: K.decode_attention_plain(q, k, v, p), 20)
    d_lib = None        # torch < 2.5 has no GQA in scaled_dot_product_attention
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        d_lib, _ = cuda_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, scale=scale, enable_gqa=True), 100)
    nbytes = 2 * B * H * hd * e + 2 * B * KV * (pos + 1) * hd * e
    d_bound, d_by = bound_ms(nbytes, 4.0 * B * H * (pos + 1) * hd, "bfloat16")
    emit("kernel_time", kernel="decode_attention",
         shape=f"B{B} KV{KV} G{G} hd{hd} S{S} pos{pos} bf16",
         kernel_ms=d_ms, kernel_eager_ms=d_eager, plain_ms=d_plain,
         library_ms=d_lib,
         library="F.scaled_dot_product_attention(enable_gqa=True)",
         bound_ms=d_bound, bound_by=d_by, bytes=nbytes,
         n_split=K.plan_splits(S, B * KV, torch.cuda.get_device_properties(
             dev).multi_processor_count),
         ptxas=ptxas_of(ptxas, "decode_attention"))

    decode_family = [decode_time(torch, K, dev, randn, ptxas, *shape)
                     for shape in DECODE_FAMILY_SHAPES]

    r_times = [rmsnorm_time(torch, K, dev, randn, ptxas, rows, d)
               for rows, d in RMSNORM_TIME_SHAPES]
    r_family = [rmsnorm_time(torch, K, dev, randn, ptxas, rows, d)
                for rows, d in RMSNORM_FAMILY_SHAPES]
    decode_serving = [decode_time(torch, K, dev, randn, ptxas, *shape)
                      for shape in DECODE_SERVING_SHAPES]
    r_serving = [rmsnorm_time(torch, K, dev, randn, ptxas, rows, d)
                 for rows, d in RMSNORM_SERVING_SHAPES]

    flash = flash_kernel_phase(torch, K, dev, randn, record, worst, ptxas)
    flash["serving_family_shapes"] = [
        flash_time(torch, K, dev, randn, ptxas, *shape)
        for shape in FLASH_SERVING_SHAPES]
    flash_compute = flash_compute_phase(torch, K, dev, randn, record, worst,
                                        ptxas, flash)
    ssm = ssm_kernel_phase(torch, K, dev, record, worst, ptxas)

    prefill_rms = [{k: t[k] for k in ("shape", "kernel_ms", "kernel_cold_ms",
                                      "library_ms", "bound_ms", "bound_share",
                                      "plan")} for t in r_times[2:]]
    rt = r_times[0]
    return [
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:92",
         "launches": None,
         "max_abs_err": max(worst["decode_attention"].values()),
         "max_abs_err_by_dtype": worst["decode_attention"], "tol": TOL,
         "ms": d_ms, "eager_ms": d_eager, "plain_ms": d_plain,
         "bound_ms": d_bound,
         "bound_by": d_by, "library_ms": d_lib,
         "timed_shape": f"B{B} KV{KV} G{G} hd{hd} S{S} pos{pos} bf16",
         "dense_family_shapes": decode_family,
         "serving_family_shapes": decode_serving,
         "ptxas": ptxas_of(ptxas, "decode_attention")},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm/kernel.py:39",
         "launches": None, "max_abs_err": max(worst["rmsnorm"].values()),
         "max_abs_err_by_dtype": worst["rmsnorm"], "tol": TOL,
         "ms": rt["kernel_ms"], "eager_ms": rt["kernel_eager_ms"],
         "plain_ms": rt["plain_ms"], "bound_ms": rt["bound_ms"],
         "bound_by": rt["bound_by"], "library_ms": rt["library_ms"],
         "timed_shape": rt["shape"], "plan": rt["plan"],
         "prefill_shapes": prefill_rms,
         "dense_family_shapes": [
             {k: t[k] for k in ("shape", "kernel_ms", "kernel_cold_ms",
                                "plain_ms", "library_ms", "bound_ms",
                                "bound_share", "plan")} for t in r_family],
         "serving_family_shapes": [
             {k: t[k] for k in ("shape", "kernel_ms", "kernel_cold_ms",
                                "plain_ms", "library_ms", "bound_ms",
                                "bound_share", "plan")} for t in r_serving],
         "ptxas": rt["ptxas"]},
        flash, flash_compute, ssm,
    ]


#: decode_attention timed at the dense family's new instances, bf16:
#: (label, B, KV, G, hd, S, pos, window)
DECODE_FAMILY_SHAPES = (
    ("gemma3-1b serve", 4, 1, 4, 256, 632, 631, None),
    ("gemma3-1b serve local", 4, 1, 4, 256, 632, 631, 512),
    ("gemma3-1b long global", 8, 1, 4, 256, 32768, 32760, None),
    ("gemma3-1b long local", 8, 1, 4, 256, 32768, 32760, 512),
    ("qwen2.5-14b", 4, 8, 5, 128, 4096, 4095, None),
    ("nemotron-4-15b", 4, 8, 6, 128, 4096, 4095, None),
)
#: decode_attention timed at the serving families' instances, bf16: the
#: self-attention of a B 4, 16 + 16 (olmoe, kimi) or 16 + 32 (whisper)
#: generate at its last position, and the one-query cross-attention of a
#: decode step over whisper's 1500 encoder rows and llama-3.2-vision's 1024
#: patches
DECODE_SERVING_SHAPES = (
    ("olmoe-1b-7b", 4, 16, 1, 128, 32, 31, None),
    ("kimi-k2 layer", 4, 8, 8, 112, 32, 31, None),
    ("whisper-large-v3 self", 4, 20, 1, 64, 48, 47, None),
    ("whisper-large-v3 cross", 4, 20, 1, 64, 1500, 1499, None),
    ("llama-3.2-vision-11b cross", 4, 8, 4, 128, 1024, 1023, None),
)
#: flash_attention timed at the serving families' prefills, bf16:
#: (label, B, Sq, Sk, H, KV, hd, causal)
FLASH_SERVING_SHAPES = (
    ("whisper-large-v3 encoder", 1, 1500, 1500, 20, 20, 64, False),
    ("whisper-large-v3 cross", 1, 448, 1500, 20, 20, 64, False),
    ("llama-3.2-vision-11b cross", 1, 2048, 1024, 32, 8, 128, False),
    ("kimi-k2 layer", 1, 2048, 2048, 64, 8, 112, True),
    ("olmoe-1b-7b", 1, 4096, 4096, 16, 16, 128, True),
)


def decode_time(torch, K, dev, randn, ptxas, label, B, KV, G, hd, S, pos,
                window) -> dict:
    """decode_attention at one bf16 shape, timed beside its plain version,
    SDPA (``enable_gqa``, the window as a boolean mask) and its bound (the
    visible keys' K and V read once, q read and out written once); emitted
    as a ``kernel_time`` line."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import blocks_per_sm

    H, e = KV * G, 2
    q = randn((B, 1, H, hd), "bfloat16")
    k, v = randn((B, S, KV, hd), "bfloat16"), randn((B, S, KV, hd), "bfloat16")
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    lo = max(0, pos - window + 1) if window else 0
    keys = pos + 1 - lo
    ms, eager = cuda_time_ms(
        torch, lambda: K.decode_attention(q, k, v, p, window=window), 50)
    plain, _ = cuda_time_ms(
        torch, lambda: K.decode_attention_plain(q, k, v, p, window=window), 5)
    lib = None          # torch < 2.5 has no GQA in scaled_dot_product_attention
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        qs = q.transpose(1, 2)
        ks, vs = k[:, lo:pos + 1].transpose(1, 2), v[:, lo:pos + 1].transpose(
            1, 2)
        lib, _ = cuda_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, enable_gqa=True), 50)
    nbytes = 2 * B * H * hd * e + 2 * B * KV * keys * hd * e
    bnd, by = bound_ms(nbytes, 4.0 * B * H * keys * hd, "bfloat16")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = dict(path=label, shape=f"B{B} KV{KV} G{G} hd{hd} S{S} pos{pos} "
                                 f"window{window} bf16",
               ms=ms, eager_ms=eager, plain_ms=plain, library_ms=lib,
               library="F.scaled_dot_product_attention(enable_gqa=True) over "
                       "the visible keys",
               bound_ms=bnd, bound_by=by, bytes=nbytes, keys_read=keys,
               n_split=K.plan_splits(S, B * KV, sms, hd=hd, itemsize=e),
               blocks_per_sm=blocks_per_sm(hd, e),
               ptxas=[ln for ln in ptxas_of(ptxas, "decode_attention")
                      if f"Li{hd}E" in ln and "bfloat16" in ln])
    emit("kernel_time", kernel="decode_attention", **out)
    del q, k, v
    torch.cuda.empty_cache()
    return out


def rmsnorm_ptxas(ptxas, plan, dtype) -> list:
    """``ptxas``'s lines of the rmsnorm instances a plan launches (either
    scale dtype, without and with the residual)."""
    kernel = {"rows": "rmsnorm_rows_kernel", "loop": "rmsnorm_loop_kernel",
              "scalar": "rmsnorm_scalar_kernel"}[plan.path]
    first = "I13__nv_bfloat16" if dtype == "bfloat16" else "If"
    lanes = f"Li{plan.lpr}ELi{plan.vpl}E" if plan.path == "rows" else ""
    return [ln for ln in ptxas
            if ln.startswith(kernel + first) and lanes in ln]


def rmsnorm_time(torch, K, dev, randn, ptxas, rows, d) -> dict:
    """rmsnorm at one bf16 shape without a residual, timed beside its plain
    version, ``F.rms_norm``, a ``copy_`` of the same bytes (what a plain
    stream reaches on this card) and its bound, with its plan and ``ptxas``
    lines; emitted as a ``kernel_time`` line.  At the prefill shapes also
    cold: calls rotate over enough x/y pairs to exceed the L2, so each
    reads its x from device memory (the warm timing reuses one x, which
    may sit in L2 in part)."""
    import torch.nn.functional as F

    e = 2
    x, s = randn((rows, d), "bfloat16"), randn((d,), "bfloat16")
    r_ms, r_eager = cuda_time_ms(torch, lambda: K.rmsnorm(x, s), 200)
    r_plain, _ = cuda_time_ms(torch, lambda: K.rmsnorm_plain(x, s),
                              200 if rows * d <= 1 << 16 else 20)
    r_lib = (cuda_time_ms(torch, lambda: F.rms_norm(x, (d,), s, 1e-6), 200)[0]
             if hasattr(F, "rms_norm") else None)          # torch >= 2.4
    y = torch.empty_like(x)      # the same bytes read and written, no math
    copy_ms = cuda_time_ms(torch, lambda: y.copy_(x), 200)[0]
    del y
    r_cold = lib_cold = None
    if rows * d >= 1 << 20:
        n = max(2, -(-3 * L2_BYTES // (2 * rows * d * e)))
        xs = [randn((rows, d), "bfloat16") for _ in range(n)]
        ys, turn = [None] * n, [0]

        def rotate(fn):
            def call():
                i = turn[0] % n
                turn[0] += 1
                ys[i] = fn(xs[i])
            return call

        iters = 20 * n
        r_cold = cuda_time_ms(torch, rotate(lambda t: K.rmsnorm(t, s)),
                              iters)[0]
        if r_lib is not None:
            lib_cold = cuda_time_ms(torch, rotate(
                lambda t: F.rms_norm(t, (d,), s, 1e-6)), iters)[0]
        del xs, ys
    nb = 2 * rows * d * e + d * e
    r_bound, r_by = bound_ms(nb, 4.0 * rows * d, "float32")
    plan = (K.plan_rows(rows, d, torch.bfloat16,
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count, True,
                        scale_dtype=torch.bfloat16)
            if hasattr(K, "plan_rows") else None)   # a tree before the plan
    out = dict(shape=f"({rows}, {d}) bf16", kernel_ms=r_ms,
               kernel_eager_ms=r_eager, kernel_cold_ms=r_cold,
               plain_ms=r_plain, library_ms=r_lib, library_cold_ms=lib_cold,
               library="F.rms_norm", copy_ms=copy_ms, bound_ms=r_bound,
               bound_by=r_by, bytes=nb, bound_share=r_bound / r_ms,
               bound_share_cold=r_bound / r_cold if r_cold else None,
               plan=plan and plan._asdict(),
               ptxas=(rmsnorm_ptxas(ptxas, plan, "bfloat16") if plan
                      else ptxas_of(ptxas, "rmsnorm")))
    emit("kernel_time", kernel="rmsnorm", **out)
    del x, s
    torch.cuda.empty_cache()
    return out


#: (B, Sq, Sk, H, KV, hd, causal, window, scale): the JAX sweep
#: (tests/test_kernels.py: head dims, GQA ratios, windows, non-causal,
#: ragged, block-shape case, custom scale), rows with no visible key, and
#: the two model paths' shapes
FLASH_CASES = (
    [(2, 256, 256, 4, 2, hd, True, None, None) for hd in (64, 112, 128)]
    + [(2, 128, 128, 8, 8 // g, 64, True, None, None) for g in (1, 2, 8)]
    + [(1, 512, 512, 4, 1, 64, True, w, None) for w in (32, 128, 511)]
    + [(2, 128, 256, 4, 4, 64, False, None, None),
       (1, 200, 200, 2, 2, 64, True, None, None),
       (1, 512, 512, 2, 1, 64, True, None, None),
       (1, 128, 128, 4, 1, 128, True, None, 1.0 / 16.0),
       (1, 256, 64, 2, 1, 64, False, 8, None),
       (2, 77, 77, 4, 2, 112, True, 1, None),
       (1, 1, 300, 4, 4, 128, False, None, None),
       # Sq not a multiple of the bf16 kernel's 128-query tile; hd 112
       (2, 300, 300, 4, 2, 128, True, None, None),
       (1, 300, 300, 4, 2, 112, True, None, None),
       (1, 190, 333, 4, 1, 64, False, 100, None),
       (4, 2048, 2048, 16, 8, 128, True, None, None),
       (1, 4096, 4096, 32, 32, 112, True, None, None)]
    # hd 256 (gemma3-1b: H 4, KV 1): causal with and without its window
    # of 512, a window edge on a query-tile edge, ragged Sq and Sk,
    # non-causal GQA 2, and the prefill's own shape with and without the
    # window (a local and a global layer)
    + [(1, 1024, 1024, 4, 1, 256, True, w, None) for w in (None, 512)]
    + [(1, 700, 700, 4, 1, 256, True, 128, None),
       (2, 300, 333, 4, 2, 256, False, None, None),
       (1, 190, 190, 4, 1, 256, True, None, None),
       (1, 8192, 8192, 4, 1, 256, True, 512, None),
       (1, 8192, 8192, 4, 1, 256, True, None, None)]
    # the serving families: whisper-large-v3's bidirectional encoder (1500
    # frames, H 20, hd 64) and its decoder's cross-attention (448 queries,
    # 1500 keys), llama-3.2-vision's cross-attention (2048 queries, 1024
    # patches, GQA 4), kimi-k2's causal prefill (H 64, KV 8, hd 112)
    + [(1, 1500, 1500, 20, 20, 64, False, None, None),
       (1, 448, 1500, 20, 20, 64, False, None, None),
       (1, 2048, 1024, 32, 8, 128, False, None, None),
       (1, 2048, 2048, 64, 8, 112, True, None, None)])

#: (B, S, H, P, N, chunk[, dt scale]): the JAX sweep
#: (tests/test_kernels_decode_ssm.py: chunks, head shapes, ragged S, state
#: continuity) and zamba2-7b's shape; then the chunk-parallel kernel's
#: edges: B > 1 at full width (groups of 8 chunks), one step past a chunk
#: with H odd, a single ragged chunk (one group, no state launch), and dt x
#: 10 so that exp(cum) underflows inside a chunk; last, the shape one rank
#: of dist_tp_zamba2 launches (56 of the 112 heads, S 2048)
SSM_CASES = ([(2, 256, 8, 32, 16, c) for c in (32, 64, 128)]
             + [(2, 256, h, p, 16, 64) for h, p in ((4, 16), (8, 64),
                                                    (16, 32))]
             + [(2, 200, 8, 32, 16, 64), (2, 512, 8, 32, 16, 128),
                (1, 300, 4, 64, 64, 128), (1, 4096, 112, 64, 64, 128)]
             + [(2, 4096, 112, 64, 64, 128), (1, 129, 3, 64, 64, 128),
                (1, 64, 112, 64, 64, 128), (1, 2048, 16, 64, 64, 128, 10.0)]
             + [(1, 2048, 56, 64, 64, 128)])
#: ssm_scan timed at zamba2-7b's prefill shape, then at one TP rank's
SSM_TIME_SHAPES = (("zamba2-7b", (1, 4096, 112, 64, 64, 128)),
                   ("zamba2-7b TP rank (1, 2)", (1, 2048, 56, 64, 64, 128)))
#: tolerances of the JAX package's SSD-scan tests, by output dtype
SSM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def flash_bound(B, S, H, KV, hd, e=2, window=None):
    """Causal self-attention at Sq = Sk = S: each of q, k, v, o crosses
    device memory once; QK^T and PV over the visible pairs (S(S+1)/2, or
    sum_i min(i + 1, window) under a sliding window) are 2 flops per
    multiply-add each."""
    nbytes = (2 * B * S * H + 2 * B * S * KV) * hd * e
    pairs = S * (S + 1) / 2
    if window is not None and window < S:
        pairs = window * (window + 1) / 2 + (S - window) * window
    flops = 4.0 * B * H * hd * pairs
    return nbytes, flops


def attn_bound(B, Sq, Sk, H, KV, hd, causal, e=2):
    """Attention at any Sq, Sk (queries and keys both from position 0):
    q, k, v, o cross device memory once; QK^T and PV over the visible
    pairs (all Sq x Sk, or the causal triangle's) are 2 flops per
    multiply-add each."""
    nbytes = (2 * B * Sq * H + 2 * B * Sk * KV) * hd * e
    pairs = (sum(min(i + 1, Sk) for i in range(Sq)) if causal
             else Sq * Sk)
    return nbytes, 4.0 * B * H * hd * pairs


def flash_fwd_bwd_bound(B, Sq, Sk, H, KV, hd, causal, window=None, e=2):
    """One forward and backward of attention: q, k, v and dO read once, o,
    dq, dk and dv written once; the forward's QK^T and PV and the
    backward's five products (QK^T recomputed, dP, dV, dQ, dK) over the
    visible pairs, 3.5 x the forward's flops."""
    if window is not None:
        pairs = sum(min(i + 1, window) for i in range(Sq))
    elif causal:
        pairs = sum(min(i + 1, Sk) for i in range(Sq))
    else:
        pairs = Sq * Sk
    nbytes = (4 * B * Sq * H + 4 * B * Sk * KV) * hd * e
    return nbytes, 14.0 * B * H * hd * pairs


def flash_time(torch, K, dev, randn, ptxas, label, B, Sq, Sk, H, KV, hd,
               causal) -> dict:
    """flash_attention at one bf16 shape (Sq may differ from Sk), timed
    beside its plain version, SDPA (``enable_gqa``; ``is_causal`` when
    causal) and its bound; emitted as a ``kernel_time`` line."""
    import torch.nn.functional as F

    q = randn((B, Sq, H, hd), "bfloat16")
    k, v = randn((B, Sk, KV, hd), "bfloat16"), randn((B, Sk, KV, hd),
                                                     "bfloat16")
    ms, eager = cuda_time_ms(
        torch, lambda: K.flash_attention(q, k, v, causal=causal), 10)
    plain, _ = cuda_time_ms(
        torch, lambda: K.flash_attention_plain(q, k, v, causal=causal), 2)
    lib = None          # torch < 2.5 has no GQA in scaled_dot_product_attention
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        lib, _ = cuda_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, enable_gqa=True), 10)
        del qs, ks, vs
    nbytes, flops = attn_bound(B, Sq, Sk, H, KV, hd, causal)
    bnd, by = bound_ms(nbytes, flops, "bfloat16")
    out = dict(path=label, shape=f"B{B} Sq{Sq} Sk{Sk} H{H} KV{KV} hd{hd} "
                                 f"causal{causal} bf16",
               ms=ms, eager_ms=eager, plain_ms=plain, library_ms=lib,
               library="F.scaled_dot_product_attention(enable_gqa=True)",
               bound_ms=bnd, bound_by=by, bytes=nbytes, flops=flops,
               tflop_s=flops / ms / 1e9)
    emit("kernel_time", kernel="flash_attention", **out,
         ptxas=flash_ptxas(ptxas, hd))
    del q, k, v
    torch.cuda.empty_cache()
    return out


def flash_ptxas(ptxas, hd: int, compute=None) -> list:
    """``ptxas``'s lines of the flash_attention instances that run at
    ``hd`` (the bf16 kernel runs hd 112 at 128): the f32 kernel's and
    the bf16 kernel's, or only the bf16 kernel's float32-mode
    (``compute=False``) or compute-mode (``compute=True``) instance."""
    import re

    hds = {hd, max(hd, 128) if hd == 112 else hd}
    out = []
    for ln in ptxas_of(ptxas, "flash_attention"):
        name = ln.split(":")[0]
        m = re.search(r"Li(\d+)(?:ELb([01]))?", name)
        if not m or int(m.group(1)) not in hds:
            continue
        if compute is not None and (m.group(2) or "0") != str(int(compute)):
            continue
        out.append(ln)
    return out


def row_rel_err(out, ref) -> float:
    """max over rows (the last axis) of |out - ref| / |ref|, rows with
    |ref| = 0 left out (the element-wise check holds those at 0)."""
    diff = (out.float() - ref.float()).norm(dim=-1)
    norm = ref.float().norm(dim=-1)
    keep = norm > 0
    return (diff[keep] / norm[keep]).max().item() if keep.any() else 0.0


#: flash_attention timed at the model paths' causal shapes, bf16: (label,
#: B, S, H, KV, hd, window)
FLASH_TIME_SHAPES = (("qwen3-1.7b", 4, 2048, 16, 8, 128, None),
                     ("zamba2-7b", 1, 4096, 32, 32, 112, None),
                     ("gemma3-1b global", 1, 8192, 4, 1, 256, None),
                     ("gemma3-1b local", 1, 8192, 4, 1, 256, 512),
                     ("qwen2.5-14b", 1, 4096, 40, 8, 128, None),
                     ("nemotron-4-15b", 1, 4096, 48, 8, 128, None))


def flash_sweep(torch, K, randn, record, name, dt, cases,
                probs="float32") -> float:
    """flash_attention in ``probs`` mode against its plain version over
    ``cases`` at ``dt``: each launch counted as ``name`` (at f32 the
    compute mode is the float32 mode's launch, ``flash_attention``),
    element-wise within TOL (``record``), bf16 also row by row within
    FLASH_BF16_ROW_REL_TOL.  Returns the largest row-relative error."""
    counter = name if dt == "bfloat16" else "flash_attention"
    worst_row_rel = 0.0
    for B, Sq, Sk, H, KV, hd, causal, win, scale in cases:
        q = randn((B, Sq, H, hd), dt)
        k, v = randn((B, Sk, KV, hd), dt), randn((B, Sk, KV, hd), dt)
        kw = dict(causal=causal, window=win, scale=scale, probs=probs)
        before = counts(K)[counter]
        out = K.flash_attention(q, k, v, **kw)
        check(counts(K)[counter] == before + 1,
              f"{name} {dt}: the launch did not count as {counter}")
        ref = K.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()),
              f"{name} {dt}: non-finite output")
        label = (f"B{B} Sq{Sq} Sk{Sk} H{H} KV{KV} hd{hd} causal{causal} "
                 f"window{win} scale{scale}")
        record(name, label, dt, out, ref)
        if dt == "bfloat16":
            rel = row_rel_err(out, ref)
            ok = rel <= FLASH_BF16_ROW_REL_TOL
            print(json.dumps({
                "case": f"{name} bf16 {label} row-relative",
                "max_row_rel_err": rel, "tol": FLASH_BF16_ROW_REL_TOL,
                "ref_rms": ref.float().square().mean().sqrt().item(),
                "ok": ok}), flush=True)
            check(ok, f"{name} bf16 {label}: row-relative error {rel} over "
                  f"{FLASH_BF16_ROW_REL_TOL}")
            worst_row_rel = max(worst_row_rel, rel)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return worst_row_rel


def flash_path_time(torch, K, dev, randn, B, S, H, KV, hd, win,
                    probs="float32") -> dict:
    """flash_attention in ``probs`` mode at one causal bf16 shape (a
    sliding window when ``win``), timed beside its plain version, SDPA
    (``is_causal``, or the window as a boolean mask) and the bound."""
    import torch.nn.functional as F

    q = randn((B, S, H, hd), "bfloat16")
    k, v = randn((B, S, KV, hd), "bfloat16"), randn((B, S, KV, hd),
                                                    "bfloat16")
    kw = dict(window=win, probs=probs)
    ms, eager = cuda_time_ms(
        torch, lambda: K.flash_attention(q, k, v, **kw), 10)
    plain, _ = cuda_time_ms(
        torch, lambda: K.flash_attention_plain(q, k, v, **kw), 2)
    lib = None          # torch < 2.5 has no GQA in scaled_dot_product_attention
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        if win is None:
            lkw = dict(is_causal=True)
        else:               # the sliding window as a boolean mask
            i = torch.arange(S, device=dev)
            lkw = dict(attn_mask=(i[None, :] <= i[:, None])
                       & (i[None, :] > i[:, None] - win))
        lib, _ = cuda_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, enable_gqa=True, **lkw), 10)
        del qs, ks, vs, lkw
    del q, k, v
    torch.cuda.empty_cache()
    nbytes, flops = flash_bound(B, S, H, KV, hd, window=win)
    bnd, by = bound_ms(nbytes, flops, "bfloat16")
    return dict(shape=f"B{B} S{S} H{H} KV{KV} hd{hd} causal"
                      f"{'' if win is None else f' window{win}'} bf16",
                ms=ms, eager_ms=eager, plain_ms=plain, library_ms=lib,
                bound_ms=bnd, bound_by=by, bytes=nbytes, flops=flops,
                tflop_s=flops / ms / 1e9)


FLASH_LIBRARY = ("F.scaled_dot_product_attention(enable_gqa=True; "
                 "is_causal, or the window as a boolean mask)")


def flash_kernel_phase(torch, K, dev, randn, record, worst, ptxas):
    """flash_attention against its plain version over FLASH_CASES (bf16
    also row by row, FLASH_BF16_ROW_REL_TOL), then timed at the model
    paths' shapes (FLASH_TIME_SHAPES)."""
    worst_row_rel = max(flash_sweep(torch, K, randn, record,
                                    "flash_attention", dt, FLASH_CASES)
                        for dt in ("float32", "bfloat16"))
    times = {}
    for label, *shape in FLASH_TIME_SHAPES:
        times[label] = flash_path_time(torch, K, dev, randn, *shape)
        emit("kernel_time", kernel="flash_attention", path=label,
             library=FLASH_LIBRARY, **times[label],
             ptxas=flash_ptxas(ptxas, shape[4], compute=False))
    main = times["qwen3-1.7b"]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:102",
            "launches": None,
            "max_abs_err": max(worst["flash_attention"].values()),
            "max_abs_err_by_dtype": worst["flash_attention"], "tol": TOL,
            "bf16_max_row_rel_err": worst_row_rel,
            "bf16_row_rel_tol": FLASH_BF16_ROW_REL_TOL, "ms": main["ms"], "eager_ms": main["eager_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "timed_shape": main["shape"],
            "other_paths": {k: t for k, t in times.items()
                            if k != "qwen3-1.7b"},
            "ptxas": ptxas_of(ptxas, "flash_attention")}

#: flash_attention's compute-probability mode (``probs="compute"``, the
#: models' ``attn_probs_dtype="compute"``) against its plain version: at
#: bf16 the hd 64 / 112 / 128 / 256 instances, GQA, windows, ragged and
#: non-causal shapes, rows with no visible key, the one-query
#: cross-attention over whisper's 1500 frames (a decode step under the
#: option), whisper's encoder and the two timed paths; at f32 (where the
#: mode is the float32 mode's launch) the small cases.  (B, Sq, Sk, H, KV,
#: hd, causal, window, scale)
FLASH_COMPUTE_CASES = (
    (2, 256, 256, 4, 2, 64, True, None, None),
    (2, 77, 77, 4, 2, 112, True, 1, None),
    (1, 128, 128, 4, 1, 128, True, None, 1.0 / 16.0),
    (1, 190, 333, 4, 1, 64, False, 100, None),
    (1, 256, 64, 2, 1, 64, False, 8, None),
    (2, 300, 300, 4, 2, 128, True, None, None),
    (1, 700, 700, 4, 1, 256, True, 128, None),
    (1, 1, 1500, 20, 20, 64, False, None, None),
    (1, 1500, 1500, 20, 20, 64, False, None, None),
    (4, 2048, 2048, 16, 8, 128, True, None, None),
    (1, 8192, 8192, 4, 1, 256, True, 512, None))
FLASH_COMPUTE_F32_CASES = FLASH_COMPUTE_CASES[:5]
#: the compute mode is timed at qwen3-1.7b's prefill and gemma3-1b's
#: local layer (labels of FLASH_TIME_SHAPES)
FLASH_COMPUTE_TIMED = ("qwen3-1.7b", "gemma3-1b local")


def flash_compute_phase(torch, K, dev, randn, record, worst, ptxas,
                        flash) -> dict:
    """flash_attention's compute-probability variant against its plain
    version (``flash_attention_plain(probs="compute")``) over
    FLASH_COMPUTE_CASES (``flash_sweep``), then timed at
    FLASH_COMPUTE_TIMED beside its plain version, SDPA and the same bound
    as the float32 mode (the same products over the same pairs), with the
    float32 mode's time from ``flash`` (this call) beside it.  Returns its
    summary entry."""
    name = "flash_attention_compute"
    worst_row_rel = max(
        flash_sweep(torch, K, randn, record, name, "bfloat16",
                    FLASH_COMPUTE_CASES, "compute"),
        flash_sweep(torch, K, randn, record, name, "float32",
                    FLASH_COMPUTE_F32_CASES, "compute"))
    times = {}
    for label, *shape in FLASH_TIME_SHAPES:
        if label not in FLASH_COMPUTE_TIMED:
            continue
        t = flash_path_time(torch, K, dev, randn, *shape, probs="compute")
        f32_mode = (flash if label == "qwen3-1.7b"
                    else flash["other_paths"][label])["ms"]
        times[label] = dict(t, float32_mode_ms=f32_mode,
                            over_float32_mode=t["ms"] / f32_mode)
        emit("kernel_time", kernel=name, path=label, library=FLASH_LIBRARY,
             **times[label], ptxas=flash_ptxas(ptxas, shape[4],
                                               compute=True))
    main = times["qwen3-1.7b"]
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:102",
            "variant_of": "flash_attention (kCompute instances)",
            "computes": "src/repro/models/layers.py:228 (_sdpa, "
                        "probs_dtype='compute')",
            "launches": None,
            "max_abs_err": max(worst[name].values()),
            "max_abs_err_by_dtype": worst[name], "tol": TOL,
            "bf16_max_row_rel_err": worst_row_rel,
            "bf16_row_rel_tol": FLASH_BF16_ROW_REL_TOL,
            "ms": main["ms"], "eager_ms": main["eager_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "float32_mode_ms": main["float32_mode_ms"],
            "timed_shape": main["shape"],
            "other_paths": {k: t for k, t in times.items()
                            if k != "qwen3-1.7b"},
            "ptxas": [ln for hd in (64, 128, 256)
                      for ln in flash_ptxas(ptxas, hd, compute=True)]}


def ssm_bound(B, S, H, P, N, Q, ex=2, ey=4):
    """Bytes: x, dt, A, B, C read once, y written once.  Flops the chunked
    form needs: C.B^T over each chunk's lower triangle (shared by the
    heads), (C.B^T o L)(dt x) over it per head, and C.h^T and the state
    update (2PN each) per step and head."""
    nc = -(-S // Q)
    tri = Q * (Q + 1) / 2
    nbytes = B * S * H * P * (ex + ey) + B * S * H * 4 + H * 4 \
        + 2 * B * S * N * ex
    flops = 2.0 * B * nc * tri * (N + H * P) + 4.0 * B * S * H * P * N
    return nbytes, flops


def ssm_fwd_bwd_bound(B, S, H, P, N, Q):
    """One forward and backward of the SSD scan at bf16 x, B, C and f32 dt,
    y: the forward's bytes plus dy read and dx, ddt, dA, dB, dC written
    once; the backward takes two products for each of the forward's, 3 x
    its flops."""
    nbytes, flops = ssm_bound(B, S, H, P, N, Q)
    nbytes += B * S * H * P * (4 + 2) + B * S * H * 4 + H * 4 \
        + 2 * B * S * N * 2
    return nbytes, 3.0 * flops


def ssm_kernel_phase(torch, K, dev, record, worst, ptxas):
    """ssm_scan against its plain version over SSM_CASES (x f32, bf16, and
    bf16 with an f32 y as mamba2_forward asks), then timed at zamba2-7b's
    shape."""
    gen = torch.Generator(device=dev).manual_seed(4321)

    def inputs(B, S, H, P, N, dtype, dt_scale=1.0):
        def n(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        return ((n(B, S, H, P) * 0.5).to(dtype),
                n(B, S, H).abs() * (0.1 * dt_scale),
                -n(H).abs() - 0.1, (n(B, S, N) * 0.3).to(dtype),
                (n(B, S, N) * 0.3).to(dtype))

    f32, bf16 = torch.float32, torch.bfloat16
    for x_dt, y_dt in ((f32, None), (bf16, None), (bf16, f32)):
        for B, S, H, P, N, chunk, *dt_scale in SSM_CASES:
            args = inputs(B, S, H, P, N, x_dt, *dt_scale)
            y = K.ssm_scan(*args, chunk=chunk, out_dtype=y_dt)
            ref = K.ssm_scan_plain(*args, chunk=chunk, out_dtype=y_dt)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y.float()).all()),
                  "ssm_scan: non-finite output")
            dt_name = str(y.dtype).removeprefix("torch.")
            record("ssm_scan", f"B{B} S{S} H{H} P{P} N{N} chunk{chunk} "
                   f"dt x{dt_scale[0] if dt_scale else 1.0} "
                   f"x {str(x_dt)[6:]}", dt_name, y, ref, SSM_TOL)
            del args, y, ref

    timed = []
    for path, (B, S, H, P, N, Q) in SSM_TIME_SHAPES:
        args = inputs(B, S, H, P, N, bf16)
        ms, eager = cuda_time_ms(
            torch, lambda: K.ssm_scan(*args, chunk=Q, out_dtype=f32), 20)
        plain, _ = cuda_time_ms(
            torch, lambda: K.ssm_scan_plain(*args, chunk=Q, out_dtype=f32),
            2)
        phases = kernel_times_by_name(
            torch, lambda: K.ssm_scan(*args, chunk=Q, out_dtype=f32), 20,
            "ssm_scan")
        nbytes, flops = ssm_bound(B, S, H, P, N, Q)
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        shape = f"B{B} S{S} H{H} P{P} N{N} chunk{Q} x bf16 y f32"
        groups = K.plan_groups(S, Q, B * H, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        emit("kernel_time", kernel="ssm_scan", path=path, shape=shape,
             ms=ms, eager_ms=eager, plain_ms=plain, library_ms=None,
             library="none (no single PyTorch call computes the SSD scan)",
             bound_ms=bnd, bound_by=by, bytes=nbytes, flops=flops,
             chunks_per_group=groups, phase_ms_per_call=phases,
             phase_ms_sum=sum(phases.values()),
             ptxas=ptxas_of(ptxas, "ssm_scan"))
        timed.append((ms, eager, plain, bnd, by, shape, phases))
        del args
    ms, eager, plain, bnd, by, shape, phases = timed[0]
    return {"name": "ssm_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan/kernel.py:79",
            "launches": None, "max_abs_err": max(worst["ssm_scan"].values()),
            "max_abs_err_by_dtype": worst["ssm_scan"], "tol": SSM_TOL,
            "ms": ms, "eager_ms": eager, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "library_ms": None, "timed_shape": shape,
            "phase_ms_per_call": phases, "ptxas": ptxas_of(ptxas, "ssm_scan"),
            "tp_rank": dict(zip(("ms", "eager_ms", "plain_ms", "bound_ms",
                                 "bound_by", "timed_shape"), timed[1][:6]))}


# ------------------------------------------------------------------ geometry

#: the paper's sweep on the card: three fleets x seven file sizes x the
#: Table II grid x this many seeds at the scenarios' own jitter
GEOMETRY_SEEDS = 32
GEOMETRY_JITTER = 0.02


def paper_fleets():
    """(names, bw, rtt, throttle_t, throttle_bw) of the six-replica FABRIC
    fleet, its Fig. 3 variant (+0.5 s on the fastest) and its Fig. 4
    variant (fastest throttled to 500 Mbps); numpy ``[3, 6]`` each."""
    import numpy as np

    from repro_torch.core.scenarios import (paper_baseline,
                                            with_added_latency,
                                            with_throttled_fastest)

    base = paper_baseline()
    fleets = {"baseline": base, "latency": with_added_latency(base),
              "throttle": with_throttled_fastest(base)}
    rows = list(fleets.values())
    return (list(fleets),
            np.asarray([[s.bandwidth for s in f] for f in rows]),
            np.asarray([[s.rtt for s in f] for f in rows]),
            np.asarray([[s.profile[0][0] if s.profile else np.inf
                         for s in f] for f in rows]),
            np.asarray([[s.profile[0][1] if s.profile else s.bandwidth
                         for s in f] for f in rows]))


def blocks_of(iters: int, k: int) -> int:
    """Steps the host ran for ``iters`` live steps: whole blocks of ``k``
    (it checks for a live lane only between blocks)."""
    return max(-(-iters // k) * k, k)


def geometry_phase(torch, dev):
    """The chunk-geometry loop on the card: the paper's sweep at its real
    size, the card against the CPU, the three engines side by side, and the
    gradient tuners."""
    import numpy as np

    from repro_torch.core import autotune as AT
    from repro_torch.core import online
    from repro_torch.core import torch_sim as TS
    from repro_torch.core.chunking import DEFAULT_MIN_CHUNK, ChunkParams
    from repro_torch.core.scenarios import GB, PAPER_FILE_SIZES

    names, bw, rtt, tt, tb = paper_fleets()
    grid = AT.default_grid()
    # scenario rows: fleet-major, then file size
    rows = [(f, size) for f in range(len(names)) for size in PAPER_FILE_SIZES]
    idx = [f for f, _ in rows]
    sizes = np.asarray([size for _, size in rows], np.float64)
    sweep_kw = dict(throttle_t=tt[idx], throttle_bw=tb[idx], grid=grid,
                    jitter=GEOMETRY_JITTER, n_seeds=GEOMETRY_SEEDS,
                    device=dev)

    # 1) the paper's sweep at its real size: 21 x 16 x 32 lanes of N 6
    timings = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        times = AT.sweep_scenarios(bw[idx], rtt[idx], sizes, **sweep_kw)
        times = times.cpu().numpy()
        timings.append(time.perf_counter() - t0)
    check(times.shape == (len(rows), len(grid)), "sweep shape")
    check(bool(np.isfinite(times).all()), "sweep has non-finite times")
    # the same lanes through the round core once more, for its rounds
    lanes = len(rows) * len(grid) * GEOMETRY_SEEDS
    b_s, b_g, b_k = len(rows), len(grid), GEOMETRY_SEEDS

    def lane_rows(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return x[:, None, None, :].expand(b_s, b_g, b_k, x.shape[-1]) \
            .reshape(lanes, x.shape[-1])

    def lane_grid(v):
        v = torch.as_tensor(v, dtype=torch.float32, device=dev)
        return v[None, :, None].expand(b_s, b_g, b_k).reshape(lanes)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = TS.simulate_round_core(
        lane_rows(bw[idx]), lane_rows(rtt[idx]), lane_rows(tt[idx]),
        lane_rows(tb[idx]),
        torch.arange(b_k, device=dev)[None, None, :].expand(
            b_s, b_g, b_k).reshape(lanes),
        (lane_grid([c for c, _ in grid]), lane_grid([l for _, l in grid]),
         lane_grid([DEFAULT_MIN_CHUNK] * len(grid))),
        torch.as_tensor(sizes, dtype=torch.float32, device=dev)[
            :, None, None].expand(b_s, b_g, b_k).reshape(lanes),
        mode="proportional",
        config=TS.SimConfig(jitter=GEOMETRY_JITTER))
    iters = res.iters.cpu().numpy()
    t_core = time.perf_counter() - t0
    core_times = res.total_time.reshape(b_s, b_g, b_k).mean(-1).cpu().numpy()
    check(np.allclose(core_times, times, rtol=1e-6),
          "the round core and sweep_scenarios disagree on the same lanes")
    host_steps = blocks_of(int(iters.max()), TS.CHECK_EVERY)
    winners = {}
    for r, (f, size) in enumerate(rows):
        c, l = grid[int(np.argmin(times[r]))]
        winners[f"{names[f]}/{size // GB}GB"] = [c / MB, l / MB]
    emit("geometry_sweep", lanes=lanes, servers=int(bw.shape[1]),
         scenarios=len(rows), grid=len(grid), seeds=GEOMETRY_SEEDS,
         jitter=GEOMETRY_JITTER, cold_s=timings[0], warm_s=timings[1],
         lanes_per_s_warm=lanes / timings[1], rounds_max=int(iters.max()),
         rounds_mean=float(iters.mean()), host_steps=host_steps,
         core_s=t_core, ms_per_round_step=t_core / host_steps * 1e3)
    emit("geometry_winners", winner_c_l_mib=winners,
         best_s={k: float(times[r].min())
                 for r, k in enumerate(winners)})

    # 2) card against CPU on a subset: the three fleets at 1 and 4 GB, 4
    # seeds; the draws are counter-based, so the lanes are alike
    sub = [(f, size) for f in range(len(names)) for size in (1 * GB, 4 * GB)]
    s_idx = [f for f, _ in sub]
    s_sizes = np.asarray([size for _, size in sub], np.float64)
    kw = dict(throttle_t=tt[s_idx], throttle_bw=tb[s_idx], grid=grid,
              jitter=GEOMETRY_JITTER, n_seeds=4)
    t0 = time.perf_counter()
    on_card = AT.sweep_scenarios(bw[s_idx], rtt[s_idx], s_sizes, device=dev,
                                 **kw).cpu().numpy()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = AT.sweep_scenarios(bw[s_idx], rtt[s_idx], s_sizes,
                                device="cpu", **kw).numpy()
    t_cpu = time.perf_counter() - t0
    same_argmin = bool((on_card.argmin(-1) == on_cpu.argmin(-1)).all())
    rel = float(np.max(np.abs(on_card - on_cpu) / np.abs(on_cpu)))
    emit("geometry_card_vs_cpu", lanes=len(sub) * len(grid) * 4,
         card_s=t_card, cpu_s=t_cpu, same_argmin=same_argmin,
         max_rel_diff=rel, rtol=1e-5)
    check(same_argmin, "card and CPU sweeps pick different winners")
    check(rel <= 1e-5, f"card and CPU sweep times differ by {rel:.3g}")

    # 3) the engines side by side at one 4 GB baseline point
    params = ChunkParams(4 * MB, 40 * MB)
    out = {}
    for engine in ("event", "round", "scan"):
        run = lambda: TS.simulate_transfer(  # noqa: E731
            bw[0], rtt[0], 4 * GB, params, engine=engine, device=dev)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run()
        total = float(r.total_time)
        ms = (time.perf_counter() - t0) * 1e3
        steps = blocks_of(int(r.iters), TS.CHECK_EVERY)
        out[engine] = {"total_time_s": total, "iters": int(r.iters),
                       "host_steps": steps, "ms": ms,
                       "ms_per_step": ms / steps}
    prof = device_profile(torch, lambda: TS.simulate_transfer(
        bw[0], rtt[0], 4 * GB, params, engine="round", device=dev), ())
    rel = abs(out["round"]["total_time_s"] / out["event"]["total_time_s"] - 1)
    emit("geometry_engines", file_gb=4, fleet="baseline",
         c_l_mib=[4, 40], engines=out, round_vs_event_rel=rel,
         round_device_busy_ms=prof["device_busy_ms"],
         round_idle_share=1 - prof["device_busy_ms"] / out["round"]["ms"],
         round_top_kernels=prof["top_kernels"][:4])
    check(rel <= 0.02, f"round engine {rel:.3%} off the event engine")

    # 4) the gradient tuners at 4 GB baseline, from the grid's winner
    live_bw, live_rtt = list(bw[0]), list(rtt[0])
    t0 = time.perf_counter()
    seed = AT.autotune_chunk_params(live_bw, live_rtt, 4 * GB, device=dev)
    t_grid = time.perf_counter() - t0
    init = (seed.params.initial_chunk, seed.params.large_chunk)
    steps = 60
    t0 = time.perf_counter()
    g = AT.tune_chunk_params_grad(live_bw, live_rtt, 4 * GB, init=init,
                                  steps=steps, device=dev)
    t_grad = time.perf_counter() - t0
    mc_steps = 40
    t0 = time.perf_counter()
    mc = online.tune_chunk_params_mcgrad(live_bw, live_rtt, 4 * GB,
                                         init=init, steps=mc_steps,
                                         device=dev)
    t_mc = time.perf_counter() - t0
    emit("geometry_grad", file_gb=4, fleet="baseline", grid_s=t_grid,
         grid_winner_mib=[init[0] / MB, init[1] / MB],
         grid_time_s=seed.predicted_time,
         grad_s=t_grad, grad_steps=g.steps,
         grad_ms_per_step=t_grad / (g.steps + 1) * 1e3,
         grad_params_mib=[g.params.initial_chunk / MB,
                          g.params.large_chunk / MB],
         grad_time_s=g.predicted_time, final_grad=list(g.final_grad),
         mcgrad_s=t_mc, mcgrad_steps=mc.steps, mcgrad_seeds=8,
         mcgrad_ms_per_step=t_mc / (mc.steps + 1) * 1e3,
         mcgrad_params_mib=[mc.params.initial_chunk / MB,
                            mc.params.large_chunk / MB],
         mcgrad_time_s=mc.predicted_time)
    check(all(math.isfinite(x) for x in g.final_grad)
          and any(x != 0.0 for x in g.final_grad),
          f"grad tuner's final gradient {g.final_grad}")
    check(g.predicted_time <= seed.predicted_time + 1e-6,
          "grad tuner is worse than its grid init")
    check(mc.predicted_time <= seed.predicted_time + 1e-6,
          "MC grad tuner is worse than its grid init")


# ------------------------------------------------------------------ restore

class MirrorFleet:
    """Throttled loopback mirrors of the checkpoint at ``d`` (under
    ``/ckpt``), one per rate; with ``kill_at`` the first (slowest) one is
    stopped, its connections killed, once it has served that many bytes.
    A context manager: every server and the watcher stop on exit."""

    def __init__(self, d: str, rates=None, kill_at=None):
        from repro_torch.transfer import RangeServer, Replica, Throttle

        rates = rates or (MIRROR_RATE, 2 * MIRROR_RATE, 4 * MIRROR_RATE)
        self.rates = list(rates)
        self.servers = []
        self.killed_at = []
        self._done = threading.Event()
        self._watcher = None
        t0 = time.perf_counter()
        try:
            for rate in self.rates:
                s = RangeServer(throttle=Throttle(bytes_per_s=rate, chunk=MB,
                                                  shared=True)).start()
                self.servers.append(s)
                for name in ("manifest.json", "data.bin"):
                    s.add_file(f"/ckpt/step_0000000001/{name}",
                               os.path.join(d, name))
        except BaseException:
            self.stop()
            raise
        self.mount_s = time.perf_counter() - t0
        self.replicas = [Replica("127.0.0.1", s.port, "/ckpt")
                         for s in self.servers]
        self.t0 = time.perf_counter()
        if kill_at is not None:
            self._watcher = threading.Thread(target=self._kill_when_due,
                                             args=(kill_at,))
            self._watcher.start()

    def _kill_when_due(self, kill_at: int) -> None:
        victim = self.servers[0]
        while not self._done.wait(0.005):
            if victim.served_bytes >= kill_at:
                self.killed_at.append(time.perf_counter() - self.t0)
                victim.stop()
                victim.kill_connections()
                return

    @property
    def served(self) -> list:
        return [s.served_bytes for s in self.servers]

    def stop(self) -> None:
        self._done.set()
        if self._watcher is not None:
            self._watcher.join()
        for s in self.servers:      # stopping a killed mirror again is a no-op
            s.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def mirrored_restore(torch, cfg, dev, root: str, d: str, tuner=None):
    """Restore the checkpoint at ``d`` over three throttled loopback mirrors
    (MIRROR_RATE x 1, 2, 4), the slowest killed once it has served
    KILL_AT_BYTES.  Returns the tree and a dict of the run's numbers."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models.transformer import model_specs

    with MirrorFleet(d, kill_at=KILL_AT_BYTES) as fleet:
        restored, _ = restore_checkpoint(root, model_specs(cfg), step=1,
                                         replicas=fleet.replicas, tuner=tuner,
                                         device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - fleet.t0
    return restored, {"restore_s": seconds, "mount_s": fleet.mount_s,
                      "served_bytes_per_mirror": fleet.served,
                      "killed_after_s": (fleet.killed_at[0]
                                         if fleet.killed_at else None),
                      "killed_served": fleet.servers[0].served_bytes}


def check_bit_exact(torch, want: dict, tree, what: str) -> int:
    from repro_torch.models.common import tree_leaves

    got = dict(tree_leaves(tree))
    check(sorted(want) == sorted(got), f"{what}: keys differ from saved")
    for key, t in want.items():
        r = got[key]
        check(r.device == t.device, f"{what}: {key} on {r.device}")
        check(r.dtype == t.dtype and r.shape == t.shape and torch.equal(r, t),
              f"{what}: leaf {key} is not bit-exact")
    return len(got)


def restore_phase(torch, cfg, dev):
    """The default-geometry restore, then (the geometry phase's step 5) the
    same checkpoint restored again with a GridTuner on the card re-planning
    (C, L) mid-restore."""
    from dataclasses import dataclass, field

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.core.online import GridTuner
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import Decoder

    @dataclass
    class TimedGridTuner(GridTuner):
        """A GridTuner that keeps each update's telemetry and seconds."""

        seen: list = field(default_factory=list)
        seconds: list = field(default_factory=list)

        def update(self, t):
            t0 = time.perf_counter()
            try:
                return super().update(t)
            finally:
                self.seen.append(t)
                self.seconds.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    source = Decoder(cfg, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_leaves(source.tree()))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        d = save_checkpoint(tmp, 1, source.tree())
        t_save = time.perf_counter() - t0
        total = os.path.getsize(os.path.join(d, "data.bin"))
        want = dict(tree_leaves(source.tree()))
        del source
        restored, run = mirrored_restore(torch, cfg, dev, tmp, d)
        t_restore = run["restore_s"]
        leaves = check_bit_exact(torch, want, restored, "restore")
        check(run["killed_after_s"] is not None,
              "the slowest mirror was never killed mid-restore")
        check(run["killed_served"] < total,
              "the killed mirror served everything")
        emit("restore", arch=cfg.name, n_layers=cfg.n_layers,
             d_model=cfg.d_model, params=n_params, bytes=total,
             dtype=cfg.dtype, init_s=t_init, save_s=t_save,
             mount_s=run["mount_s"], restore_s=t_restore,
             gb_per_s=total / t_restore / 1e9,
             mirror_rates_mib_s=[MIRROR_RATE / MB * k for k in (1, 2, 4)],
             served_bytes_per_mirror=run["served_bytes_per_mirror"],
             killed_mirror=0, killed_after_s=run["killed_after_s"],
             leaves=leaves, bit_exact=True)

        tuner = TimedGridTuner(device=dev)
        tuned, run_t = mirrored_restore(torch, cfg, dev, tmp, d, tuner=tuner)
        t_tuned = run_t["restore_s"]
        check_bit_exact(torch, want, tuned, "tuned restore")
        del tuned
        check(run_t["killed_after_s"] is not None
              and run_t["killed_served"] < total,
              "tuned restore: the slowest mirror was not killed mid-restore")
        check(tuner.updates > 0 and tuner.params is not None,
              "tuned restore: the tuner never adopted a geometry")
        # the same update alone, the card otherwise idle: does a sweep
        # queue behind the restore's leaf copies?
        alone = []
        for _ in range(3):
            t0 = time.perf_counter()
            GridTuner(device=dev).update(tuner.seen[0])
            alone.append(time.perf_counter() - t0)
        emit("restore_tuned", tuner="GridTuner", restore_s=t_tuned,
             gb_per_s=total / t_tuned / 1e9, default_restore_s=t_restore,
             default_gb_per_s=total / t_restore / 1e9,
             adopted_c_l_mib=[tuner.params.initial_chunk / MB,
                              tuner.params.large_chunk / MB],
             updates=tuner.updates, update_s_during_restore=tuner.seconds,
             update_s_alone=alone,
             telemetry_bw_mib_s=[b / MB for b in tuner.seen[0].bandwidth],
             served_bytes_per_mirror=run_t["served_bytes_per_mirror"],
             killed_after_s=run_t["killed_after_s"], bit_exact=True)
        restore_options_phase(torch, cfg, dev, tmp, d, want, total, restored)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del want
    torch.cuda.empty_cache()
    return restored


# ------------------------------------------------- restore options

def host_free_gib() -> float:
    """MemAvailable of the host, GiB (``/proc/meminfo``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 2**30
    return float("nan")


def same_bytes(torch, view, start: int, end: int, path: str) -> bool:
    """``view[start:end]`` equals the same span of the file at ``path``,
    compared 256 MiB at a time."""
    step = 256 * MB
    buf = bytearray(min(step, max(end - start, 0)))
    with open(path, "rb") as f:
        f.seek(start)
        pos = start
        while pos < end:
            n = min(step, end - pos)
            got = f.readinto(memoryview(buf)[:n])
            if got != n:
                return False
            a = torch.frombuffer(view, dtype=torch.uint8, count=n, offset=pos)
            b = torch.frombuffer(buf, dtype=torch.uint8, count=n)
            if not torch.equal(a, b):
                return False
            del a, b
            pos += n
    return True


def restore_waves_phase(torch, cfg, dev, root, d, want, total):
    """Through a TransferManager fleet with no tuner of its own, in four
    waves, the slowest mirror killed: the between-wave grid ``retune``
    runs on the card."""
    import contextlib

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core.chunking import default_chunk_params
    from repro_torch.models.transformer import model_specs
    from repro_torch.transfer import TransferManager

    waves, retunes = [], []

    def c_l(p):
        return [p.initial_chunk / MB, p.large_chunk / MB]

    def log_client(c):
        fetch0, retune0 = c.fetch, c.retune

        async def fetch(size, **kw):
            waves.append({"bytes": size, "c_l_mib": c_l(
                c._params_arg or default_chunk_params(size))})
            t0 = time.perf_counter()
            out = await fetch0(size, **kw)
            waves[-1]["s"] = time.perf_counter() - t0
            return out

        def retune(size, **kw):
            t0 = time.perf_counter()
            before = c._params_arg
            try:
                res = retune0(size, **kw)
            except Exception as e:
                retunes.append({"s": time.perf_counter() - t0,
                                "error": type(e).__name__})
                raise
            retunes.append({"s": time.perf_counter() - t0,
                            "c_l_mib": c_l(res.params),
                            "changed": res.params != before})
            return res

        c.fetch, c.retune = fetch, retune

    class LoggedManager(TransferManager):
        """Logs the blob client's waves and between-wave retunes."""

        @contextlib.asynccontextmanager
        async def session(self, replicas=None, path=None, **kw):
            async with super().session(replicas=replicas, path=path,
                                       **kw) as c:
                if c.replicas[0].path.endswith("data.bin"):
                    log_client(c)
                yield c

    wave = -(-total // 4)
    with MirrorFleet(d, kill_at=KILL_AT_BYTES) as fleet:
        mgr = LoggedManager(fleet.replicas)
        tree, _ = restore_checkpoint(root, model_specs(cfg), step=1,
                                     replicas=fleet.replicas, manager=mgr,
                                     wave_bytes=wave, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - fleet.t0
    leaves = check_bit_exact(torch, want, tree, "restore_waves")
    del tree
    torch.cuda.empty_cache()
    adopted = [r for r in retunes if "error" not in r]
    check(len(waves) == 4, f"restore_waves: {len(waves)} waves, not 4")
    check(len(adopted) >= 1,
          "restore_waves: no between-wave retune adopted a geometry")
    check(bool(fleet.killed_at), "restore_waves: the slowest mirror was "
          "never killed mid-restore")
    emit("restore_waves", restore_s=seconds, gb_per_s=total / seconds / 1e9,
         wave_bytes=wave, waves=waves, retunes=retunes,
         retunes_adopted=len(adopted),
         served_bytes_per_mirror=fleet.served,
         killed_after_s=fleet.killed_at[0],
         capacity_mib_s={name: st["capacity"] / MB
                         for name, st in mgr.snapshot().items()},
         leaves=leaves, bit_exact=True)


def restore_resume_phase(torch, cfg, dev, root, d, want, total):
    """A crash-resumable restore whose mirrors all stop at ~40% of the
    blob must raise; a second run over fresh mirrors fetches only what the
    journal lacks, and retires the journal and the spool."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core.chunking import default_chunk_params
    from repro_torch.models.transformer import model_specs
    from repro_torch.transfer import (MDTPClient, ResumeJournal,
                                      TransferIncompleteError)

    scratch = tempfile.mkdtemp(prefix="resume_", dir=root)
    jpath = os.path.join(scratch, "journal.log")
    spool = os.path.join(scratch, "data.spool")
    stop_at = int(0.4 * total)
    with MirrorFleet(d) as fleet:
        done = threading.Event()
        stopped = []

        def stop_all():
            while not done.wait(0.005):
                if sum(fleet.served) >= stop_at:
                    stopped.append(time.perf_counter() - fleet.t0)
                    for s in fleet.servers:
                        s.stop()
                        s.kill_connections()
                    return

        watcher = threading.Thread(target=stop_all)
        watcher.start()
        err = None
        try:
            restore_checkpoint(root, model_specs(cfg), step=1,
                               replicas=fleet.replicas, resume=scratch,
                               device=dev)
        except (TransferIncompleteError, OSError) as e:
            err = e
        finally:
            done.set()
            watcher.join()
        first_s = time.perf_counter() - fleet.t0
        first_served = fleet.served
    check(err is not None and bool(stopped), "restore_resume: the first run "
          "did not fail when every mirror stopped")
    spool_bytes = os.path.getsize(spool)
    jr = ResumeJournal.open(jpath, total_bytes=total, meta={"step": 1})
    journaled = sum(n for _, n in jr.covered())
    jr.close()
    check(0 < journaled < total, f"restore_resume: {journaled} bytes "
          f"journaled of {total}")

    with MirrorFleet(d) as fleet:
        tree, _ = restore_checkpoint(root, model_specs(cfg), step=1,
                                     replicas=fleet.replicas, resume=scratch,
                                     device=dev)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - fleet.t0
        second_served = fleet.served
        depth = MDTPClient(fleet.replicas).pipeline_depth
    leaves = check_bit_exact(torch, want, tree, "restore_resume")
    del tree
    torch.cuda.empty_cache()
    # slack: one large chunk per range in flight when the mirrors stopped
    # (3 mirrors x the pipeline depth), plus the manifest, fetched again
    manifest_bytes = os.path.getsize(os.path.join(d, "manifest.json"))
    chunk = default_chunk_params(total).large_chunk
    slack = len(fleet.servers) * depth * chunk + manifest_bytes
    bound = total - journaled + slack
    check(sum(second_served) <= bound, f"restore_resume: the second run "
          f"fetched {sum(second_served)} bytes, above {bound}")
    check(not os.path.exists(jpath) and not os.path.exists(spool),
          "restore_resume: the journal or the spool outlived the restore")
    shutil.rmtree(scratch, ignore_errors=True)
    emit("restore_resume", stop_at_bytes=stop_at, stopped_after_s=stopped[0],
         first_error=type(err).__name__, first_s=first_s,
         first_served_bytes=sum(first_served), journaled_bytes=journaled,
         spool_bytes=spool_bytes, second_s=second_s,
         second_served_bytes=sum(second_served),
         second_bound_bytes=bound, slack_bytes=slack,
         slack="3 mirrors x pipeline depth %d x %d MiB + manifest"
               % (depth, chunk // MB),
         leaves=leaves, bit_exact=True, scratch_retired=True)


def restore_sharded_phase(torch, cfg, dev, root, d, want, total):
    """Part 1: ``fetch_sharded`` over K = 2 host sinks, host 0's origins at
    1/4 of host 1's rates, stealing on.  Part 2: ``restore_checkpoint(
    shard_plan=(h, 2))`` for both hosts onto the card."""
    import asyncio

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import model_specs
    from repro_torch.transfer import (PeerMirror, Replica, Throttle,
                                      fetch_sharded, plan_shards)
    from repro_torch.transfer.shard import manifest_boundaries

    free_gib = host_free_gib()
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    plan = plan_shards(total, 2, manifest_boundaries(manifest))
    blob = os.path.join(d, "data.bin")
    rates = [MIRROR_RATE * k for k in (1, 2, 4)]
    with MirrorFleet(d, rates=[r // 4 for r in rates]) as slow, \
            MirrorFleet(d, rates=rates) as fast:
        origins = [[Replica(r.host, r.port, "/ckpt/step_0000000001/data.bin")
                    for r in fleet.replicas] for fleet in (slow, fast)]
        peers = [PeerMirror(path=f"/shard{h}", throttle=Throttle(
            bytes_per_s=4 * MIRROR_RATE, chunk=MB, shared=True))
            for h in range(2)]
        try:
            t0 = time.perf_counter()
            res = asyncio.run(fetch_sharded(total, plan, origins,
                                            mirrors=peers))
            seconds = time.perf_counter() - t0
            peer_served = [m.served_bytes for m in peers]
        finally:
            for m in peers:
                m.stop()
        origin_served = [slow.served, fast.served]
    for h, (s, e) in enumerate(plan.spans):
        check(same_bytes(torch, res.sinks[h].view, s, e, blob),
              f"restore_sharded: host {h}'s span is not data.bin's")
    for st in res.steals:
        check(same_bytes(torch, res.sinks[st.thief].view, st.start, st.end,
                         blob), "restore_sharded: a stolen span differs")
    check(len(res.steals) > 0 and res.stolen_bytes > 0,
          "restore_sharded: the fast host stole nothing from the slow one")
    check(all(st.victim == 0 and st.thief == 1 for st in res.steals),
          "restore_sharded: a steal did not rob the throttled host")
    del res.sinks[:]
    emit("restore_sharded_fetch", hosts=2, spans=[list(sp) for sp in
                                                  plan.spans],
         host_free_gib_before=free_gib, seconds=seconds,
         elapsed_s_per_host=res.elapsed, steals=len(res.steals),
         stolen_bytes=res.stolen_bytes,
         stolen_bytes_per_host=res.stolen_bytes_per_host,
         peer_served_bytes=peer_served,
         origin_served_bytes_per_host=[sum(o) for o in origin_served],
         origin_rates_mib_s=[[r / 4 / MB for r in rates],
                             [r / MB for r in rates]],
         spans_bit_exact=True)

    specs = model_specs(cfg)
    got, secs = [], []
    for h in range(2):
        with MirrorFleet(d) as fleet:
            tree, _ = restore_checkpoint(root, specs, step=1,
                                         replicas=fleet.replicas,
                                         shard_plan=(h, 2), device=dev)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - fleet.t0)
        got.append(dict(tree_leaves(tree)))     # None leaves are skipped
        del tree
    keys = [set(g) for g in got]
    check(not keys[0] & keys[1], "restore_sharded: the hosts' leaves overlap")
    check(keys[0] | keys[1] == set(want),
          "restore_sharded: the two hosts together miss leaves")
    for h in range(2):
        for key, t in got[h].items():
            check(t.device == want[key].device and torch.equal(t, want[key]),
                  f"restore_sharded: host {h}'s leaf {key} is not bit-exact")
    nbytes = [sum(t.numel() * t.element_size() for t in g.values())
              for g in got]
    del got
    torch.cuda.empty_cache()
    emit("restore_sharded", hosts=2, restore_s_per_host=secs,
         leaves_per_host=[len(k) for k in keys], bytes_per_host=nbytes,
         disjoint=True, complete=True, bit_exact=True)


def restore_broadcast_phase(torch, cfg, dev, root, d, want, total):
    """Two restores at once, in two threads: A serves its landed ranges
    through a PeerMirror, B lists A's mirror beside its own origins."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models.transformer import model_specs
    from repro_torch.transfer import PeerMirror, Throttle

    specs = model_specs(cfg)
    out, errors = {}, {}

    def run(name, replicas, **kw):
        try:
            t0 = time.perf_counter()
            tree, _ = restore_checkpoint(root, specs, step=1,
                                         replicas=replicas, device=dev, **kw)
            torch.cuda.synchronize()
            out[name] = (tree, time.perf_counter() - t0)
        except BaseException as e:       # re-raised below, in the caller
            errors[name] = e

    mirror = PeerMirror(throttle=Throttle(bytes_per_s=4 * MIRROR_RATE,
                                          chunk=MB, shared=True)).start()
    try:
        with MirrorFleet(d) as fleet_a, MirrorFleet(d) as fleet_b:
            ta = threading.Thread(target=run, args=("a", fleet_a.replicas),
                                  kwargs={"mirror": mirror})
            ta.start()
            # B starts once A has landed an eighth of the blob to offer
            deadline = time.perf_counter() + 120
            while (ta.is_alive() and time.perf_counter() < deadline
                   and (not mirror.bound or sum(fleet_a.served) < total // 8)):
                time.sleep(0.01)
            b_delay = time.perf_counter() - fleet_a.t0
            tb = threading.Thread(target=run, args=(
                "b", fleet_b.replicas + [mirror.replica]))
            tb.start()
            ta.join()
            tb.join()
            served_a, served_b = fleet_a.served, fleet_b.served
        peer_served = mirror.served_bytes
    finally:
        mirror.stop()
    for name, e in errors.items():
        raise CheckFailed(f"restore_broadcast: restore {name} raised "
                          f"{type(e).__name__}: {e}") from e
    leaves = check_bit_exact(torch, want, out["a"][0], "restore_broadcast A")
    check_bit_exact(torch, want, out["b"][0], "restore_broadcast B")
    secs = {k: v[1] for k, v in out.items()}
    out.clear()
    torch.cuda.empty_cache()
    check(peer_served > 0, "restore_broadcast: A's mirror served nothing")
    check(sum(served_b) < total, "restore_broadcast: B took the whole blob "
          "from its origins")
    emit("restore_broadcast", a_restore_s=secs["a"], b_restore_s=secs["b"],
         b_started_after_s=b_delay, a_origin_served_bytes=served_a,
         b_origin_served_bytes=served_b, a_mirror_served_bytes=peer_served,
         b_origin_share=sum(served_b) / total, leaves=leaves, bit_exact=True)


def checkpoint_manager_phase(torch, cfg, dev, root, tree, want):
    """``CheckpointManager(every_steps=1, keep=1, async_save=True)`` saves
    the card-resident tree twice; GC keeps the last step, which restores
    bit-exact from the local disk."""
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.models.transformer import model_specs

    mroot = tempfile.mkdtemp(prefix="manager_", dir=root)
    mgr = CheckpointManager(mroot, every_steps=1, keep=1, async_save=True)
    snapshot_s, save_s = [], []
    for step in (1, 2):
        t0 = time.perf_counter()
        check(mgr.maybe_save(step, tree), "checkpoint_manager: no save")
        snapshot_s.append(time.perf_counter() - t0)
        mgr.wait()
        save_s.append(time.perf_counter() - t0)
    kept = sorted(os.listdir(mroot))
    check(kept == ["step_0000000002"],
          f"checkpoint_manager: GC kept {kept}")
    t0 = time.perf_counter()
    back, step = restore_checkpoint(mroot, model_specs(cfg), device=dev)
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t0
    check(step == 2, f"checkpoint_manager: restored step {step}")
    leaves = check_bit_exact(torch, want, back, "checkpoint_manager")
    del back
    torch.cuda.empty_cache()
    shutil.rmtree(mroot, ignore_errors=True)
    emit("checkpoint_manager", every_steps=1, keep=1, async_save=True,
         snapshot_s=snapshot_s, save_s=save_s, kept=kept,
         local_restore_s=local_s, leaves=leaves, bit_exact=True)


def restore_options_phase(torch, cfg, dev, root, d, want, total, tree):
    """Every tail option of ``restore_checkpoint`` at full size."""
    restore_waves_phase(torch, cfg, dev, root, d, want, total)
    restore_resume_phase(torch, cfg, dev, root, d, want, total)
    restore_sharded_phase(torch, cfg, dev, root, d, want, total)
    restore_broadcast_phase(torch, cfg, dev, root, d, want, total)
    checkpoint_manager_phase(torch, cfg, dev, root, tree, want)
    restore_dtensor_phase(torch, cfg, dev, root, d, want)


# ------------------------------------------------------------------ serve

def serve_phase(torch, K, cfg, dev, params):
    """qwen3-1.7b's ``generate`` on the restored weights, every step a
    replay of the captured step; then the kernel path against the plain
    path, teacher-forced, and the captured step against the eager one."""
    from repro_torch.models.transformer import Decoder

    model = Decoder(cfg, params, device=dev)
    B, S0, gen = 4, 16, 32
    prompt = torch.randint(0, cfg.vocab_size, (B, S0), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    per_step = {"decode_attention": cfg.n_layers,
                "rmsnorm": 4 * cfg.n_layers + 1,   # ln1, ln2, q/k-norm; final
                "flash_attention": 0, "ssm_scan": 0}
    torch.cuda.reset_peak_memory_stats()
    toks, elapsed, step, launches = captured_generate(
        torch, K, cfg, model, prompt, gen, dev, per_step, "serve")
    peak = torch.cuda.max_memory_allocated()
    steps = S0 + gen
    params = model.tree()
    hold = hold_decode_steps(torch, cfg, params, toks, 4, dev, "qwen3 serve")
    emit("serve", batch=B, prompt_len=S0, gen=gen, steps=steps,
         seconds=elapsed, ms_per_step=elapsed / steps * 1e3,
         tokens_per_s=B * steps / elapsed,
         generated_tokens_per_s=B * gen / elapsed,
         max_memory_allocated=peak, launches=launches,
         launches_per_step=step.launches, replays=step.replays, **hold)
    eager_ms = graph_vs_eager(torch, K, cfg, model, prompt, gen, toks, step,
                              elapsed, dev)
    return launches, params, toks, eager_ms


def captured_generate(torch, K, cfg, model, prompt, gen, dev, per_step,
                      what, memory=None):
    """``generate`` on the card (every step a replay of one captured step)
    after a short warm-up: the tokens, host seconds, the captured step and
    the launches of the run, ``launches[name] * replays``.  The wrappers
    count while the step is warmed up and captured, not at replays: each
    must have counted ``per_step`` launches twice, and the graph must
    replay once per position.  ``memory``: what encdec / vlm decode
    against."""
    from repro_torch.launch.serve import generate

    B, S0 = prompt.shape
    generate(cfg, model, prompt[:, :2], 2, device=dev,
             memory=memory)                                   # warm-up
    torch.cuda.synchronize()
    reset_counts(K)
    log = []
    t0 = time.perf_counter()
    toks = generate(cfg, model, prompt, gen, device=dev, step_log=log,
                    memory=memory)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    wrapper = counts(K)
    check(len(log) == 1, f"{what}: {len(log)} captured steps")
    step = log[0]
    check(step.replays == S0 + gen, f"{what}: {step.replays} replays for "
          f"{S0 + gen} positions")
    for name, n in per_step.items():
        check(step.launches[name] == n, f"{what} {name}: {step.launches[name]}"
              f" launches captured per step, expected {n}")
        check(wrapper[name] == 2 * n, f"{what} {name}: the wrapper counted "
              f"{wrapper[name]}, expected {n} warming up and {n} capturing")
    check(tuple(toks.shape) == (B, S0 + gen), f"tokens {tuple(toks.shape)}")
    check(torch.equal(toks[:, :S0], prompt), "prompt not preserved")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token range")
    launches = {name: step.launches[name] * step.replays for name in KERNELS}
    return toks, elapsed, step, launches


def zero_cache(step) -> None:
    """A captured step's cache back to zeros, for a new sequence."""
    from repro_torch.models.common import tree_leaves

    for _, leaf in tree_leaves(step.cache):
        leaf.zero_()


#: the port's kernels by their names in a profile (one entry per launch of
#: the wrapper: the split-K merge and the SSD scan's phases are left out)
KERNEL_NAME_RE = {"decode_attention": r"decode_attention_kernel<",
                  "rmsnorm": r"rmsnorm_(rows|loop|scalar)_kernel<",
                  "flash_attention": r"flash_attention(_wgmma)?_kernel<"}


#: profiles of a captured step's replays taken before its launch counts
#: are held to fail: a trace under graph replay can lose kernel records
#: (whisper's step, ~1,500 kernels a replay, once showed 49 of its 64
#: decode_attention launches per replay); a graph replays every kernel
#: it holds, so a lower count is the tracer's, a higher one never is
GRAPH_PROFILE_ATTEMPTS = 3


def graph_profile(torch, step, toks, n: int, what: str) -> dict:
    """The port's kernels counted by name over ``n`` replays of a captured
    step (``torch.profiler``, after one replay of warm-up inside the
    profile, so that the tracer is running when the window opens), held to
    the launches captured (decode uses no ssm_scan launch); a profile that
    counts fewer, never more, is taken again, up to
    ``GRAPH_PROFILE_ATTEMPTS`` in all, and every attempt's counts are
    returned.  Then the host time per replay, ``n`` replays back to back.
    The traced device time is reported as traced: under graph replay it
    exceeds the replay's own time (the eager profile gives the kernels'
    device time)."""
    import re

    from torch.profiler import ProfilerActivity, profile, schedule

    dev = toks.device
    positions = torch.arange(n + 1, dtype=torch.int32, device=dev)
    attempts = []
    for _ in range(GRAPH_PROFILE_ATTEMPTS):
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=n,
                                  repeat=1)) as prof:
            for t in range(n + 1):
                step(toks[:, t:t + 1], positions[t])
                torch.cuda.synchronize()
                prof.step()
        kernels = [e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")
                   and dev_us(e) > 0]
        by_name = {name: sum(e.count for e in kernels if re.search(rx, e.key))
                   / n for name, rx in KERNEL_NAME_RE.items()}
        attempts.append(by_name)
        if not any(per < step.launches[name] for name, per in by_name.items()):
            break
    for name, per in by_name.items():
        check(per == step.launches[name], f"{what}: the profile shows {per} "
              f"{name} launches per replay, the capture {step.launches[name]}"
              f" (attempts {attempts})")
    check(step.launches["ssm_scan"] == 0, f"{what}: ssm_scan in a decode step")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for t in range(n):
            step(toks[:, t:t + 1], positions[t])
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) / n * 1e3
    return {"replay_ms_per_step": replay_ms,
            "profiled_launches_per_replay": by_name,
            "profile_attempts": attempts,
            "graph_traced_busy_ms_per_step": sum(dev_us(e) for e in kernels)
            / n / 1e3}


def graph_vs_eager(torch, K, cfg, model, prompt, gen, toks, step, captured_s,
                   dev) -> float:
    """``dense_graph``: the same ``generate`` with the step run eagerly
    (``capture=False``): tokens identical; then the captured step,
    teacher-forced over the run's tokens, against the eager step (logits
    within ``GRAPH_ATOL``); ms per step of both paths and each one's
    device idle share.  Returns the eager ms per step."""
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import decode_step, init_cache

    B, S0 = prompt.shape
    steps = S0 + gen
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = generate(cfg, model, prompt, gen, device=dev, capture=False)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    check(torch.equal(eager, toks), f"{cfg.name}: captured and eager "
          f"generate disagree on tokens")
    params = model.tree()
    zero_cache(step)
    cache = init_cache(cfg, B, steps, dev)
    diffs, equal = [], 0
    with torch.inference_mode():
        for t in range(steps):
            pos = torch.tensor(t, dtype=torch.int32, device=dev)
            le, cache = decode_step(params, cfg, cache, toks[:, t:t + 1], pos)
            _, lc = step(toks[:, t:t + 1], pos)
            le = le.float()
            diffs.append((lc - le).abs().max().item())
            equal += int(torch.equal(lc, le))
    del cache
    check(max(diffs) <= GRAPH_ATOL, f"{cfg.name}: captured vs eager logits "
          f"differ by {max(diffs)} (atol {GRAPH_ATOL})")
    zero_cache(step)
    prof = graph_profile(torch, step, toks, 4, f"{cfg.name} graph")
    cap_ms, eager_ms = captured_s / steps * 1e3, eager_s / steps * 1e3
    busy = profile_phase(torch, cfg, dev, params, toks, eager_ms)
    emit("dense_graph", arch=cfg.name, batch=B, prompt_len=S0, gen=gen,
         tokens_identical=True, generate_ms_per_step=cap_ms,
         eager_ms_per_step=eager_ms, device_busy_ms_per_step=busy,
         eager_device_idle_share=1.0 - busy / eager_ms,
         captured_device_idle_share=1.0 - busy / prof["replay_ms_per_step"],
         teacher_forced_steps=steps, logits_max_abs_diff=max(diffs),
         logits_atol=GRAPH_ATOL, bit_equal_steps=equal,
         launches_per_replay=step.launches, **prof)
    return eager_ms


def hold_decode_steps(torch, cfg, params, toks, n_cmp, dev, what, *,
                      start=0, caches=None) -> dict:
    """The kernel path against the plain path on the card, ``n_cmp``
    teacher-forced eager steps from position ``start`` (from a copy of the
    given cache each, else from zeros): within atol 0.08 / rtol 0.05 and
    cosine > 0.999."""
    from repro_torch.models.transformer import decode_step, init_cache

    atol, rtol = 0.08, 0.05
    B = toks.shape[0]
    if caches is None:
        ck, cp = (init_cache(cfg, B, start + n_cmp, dev) for _ in range(2))
    else:
        ck, cp = caches
    errs, coss = [], []
    with torch.inference_mode():
        for t in range(start, start + n_cmp):
            pos = torch.tensor(t, dtype=torch.int32, device=dev)
            lk, ck = decode_step(params, cfg, ck, toks[:, t:t + 1], pos)
            lp, cp = decode_step(params, cfg, cp, toks[:, t:t + 1], pos,
                                 plain=True)
            lk, lp = lk.float(), lp.float()
            check(bool(torch.isfinite(lk).all()),
                  f"{what}: non-finite logits, step {t}")
            errs.append((lk - lp).abs().max().item())
            coss.append(torch.nn.functional.cosine_similarity(
                lk.flatten(), lp.flatten(), dim=0).item())
            check(torch.allclose(lk, lp, atol=atol, rtol=rtol),
                  f"{what} step {t}: kernel vs plain logits differ by "
                  f"{errs[-1]}")
    check(min(coss) > 0.999, f"{what}: cosine similarity {min(coss)}")
    return {"plain_vs_kernel_max_abs_err": max(errs),
            "plain_vs_kernel_tol": {"atol": atol, "rtol": rtol,
                                    "cosine_min": 0.999},
            "cosine_similarity_min": min(coss), "teacher_forced_steps": n_cmp,
            "teacher_forced_from": start}


def profile_phase(torch, cfg, dev, params, toks, ms_per_step: float,
                  memory=None):
    """Where an eager decode step's time goes: device time by kernel over a
    few steps under ``torch.profiler``, set against the unprofiled step
    time.  Returns the device busy ms per step: a captured step replays
    the same kernels, so its idle share is measured against this too
    (under graph replay the tracer's own per-kernel times come out
    inflated)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import decode_step, init_cache

    n = 4
    cache = init_cache(cfg, toks.shape[0], n, dev,
                       mem_len=0 if memory is None else memory.shape[1])
    if memory is not None:
        cache["memory"].copy_(memory)
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(n):
            pos = torch.tensor(t, dtype=torch.int32, device=dev)
            decode_step(params, cfg, cache, toks[:, t:t + 1], pos)
        torch.cuda.synchronize()

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / n / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    ours = [e for e in kernels
            if "_kernel" in e.key and ("decode_attention" in e.key
                                       or "rmsnorm_" in e.key)]
    emit("profile", arch=cfg.name, steps=n, device_busy_ms_per_step=busy_ms,
         step_ms_unprofiled=ms_per_step,
         device_idle_share=(1.0 - busy_ms / ms_per_step) if busy_ms else None,
         top_kernels=[{"name": e.key[:90], "ms_per_step": dev_us(e) / n / 1e3,
                       "calls_per_step": e.count / n,
                       "us_per_call": dev_us(e) / max(e.count, 1)}
                      for e in top],
         port_kernels=[{"name": e.key[:90], "ms_per_step": dev_us(e) / n / 1e3,
                        "calls_per_step": e.count / n,
                        "us_per_call": dev_us(e) / max(e.count, 1)}
                       for e in ours])
    return busy_ms


# ------------------------------------------------------------------ prefill

def counts(K) -> dict:
    return {**{name: getattr(K, name).launches for name in KERNELS},
            **{name: getattr(getattr(K, w), attr)
               for name, (w, attr) in VARIANTS.items()}}


def reset_counts(K) -> None:
    for name in KERNELS + MESH_KERNELS:
        getattr(K, name).launches = 0
    for w, attr in VARIANTS.values():
        setattr(getattr(K, w), attr, 0)


def device_profile(torch, fn, names) -> dict:
    """Device time by kernel over one call of ``fn`` (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev_us(e) > 0]
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return {"device_busy_ms": sum(dev_us(e) for e in kernels) / 1e3,
            "top_kernels": [{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                             "calls": e.count} for e in top],
            "port_kernels": {n: sum(dev_us(e) for e in kernels
                                    if n in e.key and "kernel" in e.key)
                             / 1e3 for n in names}}


def f32_model(cfg, params):
    """The same model with its weights upcast to f32."""
    from repro_torch.models.common import tree_map

    return cfg.replace(dtype="float32"), tree_map(lambda t: t.float(), params)


def _angle(torch, a, b) -> float:
    cos = torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(),
                                                dim=0)
    return torch.arccos(cos.clamp(-1.0, 1.0)).item()


def hold_kernel_path(torch, lk, lp, k32, l32, what: str) -> dict:
    """Logits of the kernel path against the plain path, at bf16 (lk, lp)
    and with the weights upcast to f32 (k32, l32).

    f32: within atol = rtol = 1e-2 and cosine > 0.99999.  f32 rounding is
    2^16 times finer than bf16's; a kernel fault (mask, GQA index, state
    carry) moves logits by O(1).
    bf16: the plain path rounds attention probabilities to bf16 where the
    kernel keeps them f32, and a deep random model amplifies bf16 rounding
    (zamba2-7b's plain bf16 logits sit far from its f32 ones), so the bound
    is measured in this run: the plain path's own distance from the f32
    plain path, in max abs error and in angle.  Both bf16 paths within it
    of the f32 logits put them within twice it of each other (the
    triangle bound).  On zamba2-7b that floor is so wide (about 0.67 rad)
    that the bf16 hold is information, not a limit: there the f32 hold and
    the kernel sweeps at the path's shapes in bf16 are the limits."""
    lk, lp, k32, l32 = (t.float() for t in (lk, lp, k32, l32))
    for name, t in (("bf16", lk), ("f32", k32)):
        check(bool(torch.isfinite(t).all()),
              f"{what}: non-finite {name} logits")
    err32 = (k32 - l32).abs().max().item()
    cos32 = torch.nn.functional.cosine_similarity(
        k32.flatten(), l32.flatten(), dim=0).item()
    check(torch.allclose(k32, l32, atol=1e-2, rtol=1e-2) and cos32 > 0.99999,
          f"{what}: f32 kernel vs plain logits differ by {err32} "
          f"(cosine {cos32})")
    floor = (lp - l32).abs().max().item()
    err = (lk - lp).abs().max().item()
    ang_floor, ang = _angle(torch, lp, l32), _angle(torch, lk, lp)
    check(err <= 2 * floor, f"{what}: bf16 kernel vs plain logits differ by "
          f"{err}, over twice the bf16 floor {floor}")
    check(ang <= 2 * ang_floor, f"{what}: bf16 kernel vs plain logits at "
          f"angle {ang}, over twice the bf16 floor {ang_floor}")
    cos = torch.nn.functional.cosine_similarity(lk.flatten(), lp.flatten(),
                                                dim=0).item()
    return {"f32_max_abs_err": err32, "f32_cosine": cos32,
            "f32_tol": {"atol": 1e-2, "rtol": 1e-2, "cosine_min": 0.99999},
            "bf16_max_abs_err": err, "bf16_cosine": cos,
            "bf16_floor_max_abs": floor, "bf16_angle": ang,
            "bf16_floor_angle": ang_floor,
            "bf16_tol": "max_abs_err <= 2 * floor, angle <= 2 * floor angle",
            "bf16_argmax_agree": (lk.argmax(-1) == lp.argmax(-1)).float()
            .mean().item()}


def timed_prefill(torch, step, params, batch, reps: int) -> tuple:
    """(host-clock seconds per prefill, each ended by a synchronize; the
    last prefill's logits)."""
    secs, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs, out


def prefill_phase(torch, K, cfg, dev, params):
    """qwen3-1.7b's full-sequence prefill on the restored weights at B 4,
    S 2048 (``run_prefill``)."""
    return run_prefill(torch, K, cfg, params, PREFILL_SHAPE, "prefill", 2)


# ------------------------------------------------------------------ hybrid

def hybrid_phase(torch, K, dev):
    """zamba2-7b at full width and depth, random weights from a seeded
    ``torch.Generator`` on the card: prefill at B 1, S 4096 (launches per
    forward held exact, kernel path against plain path), then ``generate``
    at B 2, 16 + 16 tokens (13 decode_attention launches per replay of
    the captured step) with four teacher-forced steps held against the
    plain path, and the captured step against the eager one."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_cache)

    cfg = get_config("zamba2-7b")
    model, params, n_params, t_init = random_model(torch, cfg, dev)
    n_groups = cfg.n_layers // cfg.hybrid_period
    per_fwd = {"flash_attention": n_groups, "ssm_scan": cfg.n_layers,
               # ln1 of every mamba block, ln1 + ln2 of each shared
               # application, the final norm (zamba2 has no qk-norm)
               "rmsnorm": cfg.n_layers + 2 * n_groups + 1,
               "decode_attention": 0}
    launches = run_prefill(torch, K, cfg, params, HYBRID_SHAPE,
                           "hybrid_prefill", 3, per_fwd=per_fwd,
                           n_params=n_params, init_s=t_init)

    # generate: greedy decode through the ported kernels only, every step
    # a replay of the captured step
    B, S0, gen = 2, 16, 16
    prompt = torch.randint(0, cfg.vocab_size, (B, S0), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(4))
    per_step = {"decode_attention": n_groups, "rmsnorm": per_fwd["rmsnorm"],
                "flash_attention": 0, "ssm_scan": 0}
    toks, elapsed, graph_step, gen_launches = captured_generate(
        torch, K, cfg, model, prompt, gen, dev, per_step, "hybrid generate")
    steps = S0 + gen

    n_cmp = 4
    cfg32, p32 = f32_model(cfg, params)
    caches = {"k": init_cache(cfg, B, S0, dev), "p": init_cache(cfg, B, S0, dev),
              "k32": init_cache(cfg32, B, n_cmp, dev),
              "p32": init_cache(cfg32, B, n_cmp, dev)}
    errs, dec_logits = [], []
    with torch.inference_mode():
        for t in range(S0):
            pos = torch.tensor(t, dtype=torch.int32, device=dev)
            tok = toks[:, t:t + 1]
            lk, _ = decode_step(params, cfg, caches["k"], tok, pos)
            dec_logits.append(lk.float())
            if t < n_cmp:
                lp, _ = decode_step(params, cfg, caches["p"], tok, pos,
                                    plain=True)
                k32, _ = decode_step(p32, cfg32, caches["k32"], tok, pos)
                l32, _ = decode_step(p32, cfg32, caches["p32"], tok, pos,
                                     plain=True)
                errs.append(hold_kernel_path(torch, lk, lp, k32, l32,
                                             f"zamba2 decode step {t}"))
        del p32, caches
        full, _ = forward(params, cfg, {"tokens": toks[:, :S0]})
    dec = torch.stack(dec_logits, dim=1)
    full = full.float()
    emit("hybrid_generate", arch=cfg.name, batch=B, prompt_len=S0, gen=gen,
         steps=steps, seconds=elapsed, ms_per_step=elapsed / steps * 1e3,
         tokens_per_s=B * steps / elapsed, launches=gen_launches,
         launches_per_step=graph_step.launches, replays=graph_step.replays,
         plain_vs_kernel=errs, teacher_forced_steps=n_cmp,
         decode_vs_forward_max_abs_diff=(dec - full).abs().max().item(),
         decode_vs_forward_cosine=torch.nn.functional.cosine_similarity(
             dec.flatten(), full.flatten(), dim=0).item())
    graph_vs_eager(torch, K, cfg, model, prompt, gen, toks, graph_step,
                   elapsed, dev)
    del model, params, graph_step
    torch.cuda.empty_cache()
    return launches, gen_launches


# ------------------------------------------------------------ dense family

def random_model(torch, cfg, dev):
    """A decoder of ``cfg`` at full width and depth, random weights drawn
    on the card from seed 0: (model, params, parameter count, seconds)."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import Decoder, num_params

    t0 = time.perf_counter()
    model = Decoder(cfg, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    params = model.tree()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    check(n_params == num_params(cfg), f"{cfg.name}: {n_params} parameters")
    return model, params, n_params, time.perf_counter() - t0


class _UpcastLayers:
    """A stacked ``[L, ...]`` parameter leaf whose per-layer slices come out
    in f32: an f32 forward of a model whose whole f32 copy would not fit
    on the card beside its bf16 one holds one layer in f32 at a time."""

    def __init__(self, t):
        self.t = t

    def __getitem__(self, layer):
        return self.t[layer].float()


def f32_streamed(cfg, params):
    """``f32_model`` with the stacked blocks upcast layer by layer."""
    from repro_torch.models.common import tree_map

    tree = {k: tree_map(_UpcastLayers if k == "blocks" else
                        (lambda t: t.float()), v) for k, v in params.items()}
    return cfg.replace(dtype="float32"), tree


def run_prefill(torch, K, cfg, params, shape, phase, seed, *,
                per_fwd=None, streamed=False, reps=3, inputs=None,
                plain_q_block=1024, probe=None, pinned=False,
                profile_seq=None, **extra) -> dict:
    """A full-sequence prefill (``make_prefill_step``) at ``shape``:
    launches per forward held exact (``per_fwd``; a dense model's L
    flash_attention and (4 or 2) L + 1 rmsnorm by default), the kernel
    path held against the plain path at bf16 and f32
    (``hold_kernel_path``; ``streamed``: the f32 weights upcast one layer at
    a time), time per prefill (median of ``reps``), prompt tokens/s, idle
    share, top kernels.  ``inputs``: the batch's frames / patches;
    ``plain_q_block``: the plain path's attention query block.  With a
    ``MoEProbe``, each hold run's dropped (token, slot) pairs are counted,
    equal on the f32 kernel and plain paths; ``pinned`` (a model whose f32
    copy does not fit): the bf16 hold alone at the decode-step tolerance,
    the kernel path routed as the plain path chose (``MoEProbe``).
    ``profile_seq``: the device profile covers a forward over the first
    ``profile_seq`` positions, its times scaled by S / ``profile_seq``
    (for a forward linear in S whose full-length trace would hold
    hundreds of thousands of kernels).  Returns the launches of the timed
    prefills."""
    from repro_torch.serve.step import make_prefill_step

    dev = params["embed"].device
    B, S = shape
    L = cfg.n_layers
    per_fwd = per_fwd or {"flash_attention": L,
                          "rmsnorm": (4 if cfg.qk_norm else 2) * L + 1,
                          "decode_attention": 0, "ssm_scan": 0}
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed))
    batch = {"tokens": tokens, **(inputs or {})}
    step = make_prefill_step(cfg)
    plain_step = make_prefill_step(cfg, plain=True, q_block=plain_q_block)
    with torch.inference_mode():
        step(params, batch)                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(K)
        secs, lk = timed_prefill(torch, step, params, batch, reps)
        launches = counts(K)
        peak = torch.cuda.max_memory_allocated()
        for name, n in per_fwd.items():
            check(launches[name] == n * reps,
                  f"{phase} {cfg.name} {name}: {launches[name]} launches, "
                  f"expected {n} x {reps}")
        (plain_s,), lp = timed_prefill(torch, plain_step, params, batch, 1)

        def hold_run(fn, *a, **kw):
            if probe is None:
                return fn(*a), None
            return probe.run(lambda: fn(*a), **kw)

        if pinned:
            (lp, dp), rec = hold_run(plain_step, params, batch, record=True)
            (lk, dk), flips = hold_run(step, params, batch, replay=rec)
            check(tuple(lk.shape) == (B, cfg.vocab_size),
                  f"{phase}: logits {tuple(lk.shape)}")
            cmp = hold_fixed(torch, lk, lp, f"{cfg.name} prefill")
            cmp.update(dropped_pairs={"bf16_kernel": dk, "bf16_plain": dp},
                       routing_pinned_to_plain=True,
                       routing_flips_pinned=flips)
            check(dk == dp, f"{phase}: {dk} pairs dropped on the kernel "
                  f"path, {dp} on the plain path")
        else:
            dk = dp = None              # the timed runs' logits, unprobed
            if probe is not None:
                lk, dk = hold_run(step, params, batch)
                lp, dp = hold_run(plain_step, params, batch)
            cfg32, p32 = (f32_streamed if streamed else f32_model)(cfg,
                                                                   params)
            k32, dk32 = hold_run(make_prefill_step(cfg32), p32, batch)
            l32, dp32 = hold_run(make_prefill_step(
                cfg32, plain=True, q_block=plain_q_block), p32, batch)
            del p32
            torch.cuda.empty_cache()
            check(tuple(lk.shape) == (B, cfg.vocab_size)
                  and lk.dtype == torch.float32,
                  f"{phase}: logits {tuple(lk.shape)} {lk.dtype}")
            cmp = hold_kernel_path(torch, lk, lp, k32, l32,
                                   f"{cfg.name} prefill")
            if probe is not None:
                cmp["dropped_pairs"] = {"bf16_kernel": dk, "bf16_plain": dp,
                                        "f32_kernel": dk32, "f32_plain": dp32}
                check(dk32 == dp32, f"{phase}: {dk32} pairs dropped on the "
                      f"f32 kernel path, {dp32} on the f32 plain path")
            del k32, l32
        del lk, lp
        pbatch, scale = batch, 1
        if profile_seq:
            # a forward whose cost is linear in S (no attention), profiled
            # over its first profile_seq positions and scaled to S
            n = min(profile_seq, S)
            pbatch = {k: v[:, :n] for k, v in batch.items()}
            scale = S / n
        prof = device_profile(torch, lambda: step(params, pbatch), KERNELS)
        prof["device_busy_ms"] *= scale
        prof["port_kernels"] = {k: v * scale
                                for k, v in prof["port_kernels"].items()}
    ms = sorted(secs)[len(secs) // 2] * 1e3
    emit(phase, arch=cfg.name, batch=B, seq=S, reps=reps, ms_per_prefill=ms,
         ms_all=[t * 1e3 for t in secs], prompt_tokens_per_s=B * S / (ms / 1e3),
         plain_ms=plain_s * 1e3, max_memory_allocated=peak,
         max_memory_allocated_with_holds=torch.cuda.max_memory_allocated(),
         launches=launches,
         launches_per_forward={k: v / reps for k, v in launches.items()},
         plain_vs_kernel=cmp, f32_hold="none (bf16 only)" if pinned else
         "per-layer upcast, full depth" if streamed else "whole model in f32",
         device_busy_ms=prof["device_busy_ms"],
         device_idle_share=1.0 - prof["device_busy_ms"] / ms,
         device_busy_from=f"profile of the first {min(profile_seq, S)} "
         f"positions x {scale}" if profile_seq else "profile of the prefill",
         port_kernels_ms=prof["port_kernels"], top_kernels=prof["top_kernels"],
         **extra)
    torch.cuda.empty_cache()
    return launches


def prompt_for(torch, cfg, shape, dev, seed):
    """The ``[B, S0]`` prompt of a (B, S0, generated) ``shape``, from a
    seeded generator on the card."""
    B, S0, _ = shape
    return torch.randint(0, cfg.vocab_size, (B, S0), device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(seed))


def dense_generate(torch, K, cfg, model, shape, phase, seed, *,
                   per_step=None, memory=None, **extra):
    """The captured ``generate`` at ``shape`` (B, prompt, generated): L
    decode_attention and the model's rmsnorm launches per replay (or
    ``per_step``), one replay per position, the replays' kernels counted
    by name in a profile, ms per step and idle share.  ``memory``: what
    encdec / vlm decode against.  Returns (launches, tokens, the captured
    step, ms per step)."""
    B, S0, gen = shape
    L = cfg.n_layers
    dev = model.tree()["embed"].device
    per_step = per_step or {"decode_attention": L,
                            "rmsnorm": (4 if cfg.qk_norm else 2) * L + 1,
                            "flash_attention": 0, "ssm_scan": 0}
    prompt = prompt_for(torch, cfg, shape, dev, seed)
    torch.cuda.reset_peak_memory_stats()
    toks, elapsed, step, launches = captured_generate(
        torch, K, cfg, model, prompt, gen, dev, per_step, f"{phase} {cfg.name}",
        memory=memory)
    peak = torch.cuda.max_memory_allocated()
    steps = S0 + gen
    ms = elapsed / steps * 1e3
    zero_cache(step)
    if memory is not None:
        step.cache["memory"].copy_(memory)
    prof = graph_profile(torch, step, toks, 4, f"{phase} {cfg.name}")
    busy = profile_phase(torch, cfg, dev, model.tree(), toks,
                         prof["replay_ms_per_step"], memory=memory)
    emit(phase, arch=cfg.name, batch=B, prompt_len=S0, gen=gen, steps=steps,
         seconds=elapsed, generate_ms_per_step=ms,
         tokens_per_s=B * steps / elapsed,
         generated_tokens_per_s=B * gen / elapsed, max_memory_allocated=peak,
         launches=launches, launches_per_step=step.launches,
         replays=step.replays, device_busy_ms_per_step=busy,
         device_idle_share=1.0 - busy / prof["replay_ms_per_step"],
         **prof, **extra)
    return launches, toks, step, ms


def hold_decode_kernel_path(torch, cfg, params, toks, n_cmp, what, *,
                            memory=None, probe=None) -> list:
    """``hold_kernel_path`` over ``n_cmp`` teacher-forced decode steps from
    zero caches: at bf16, and with the weights upcast to f32 one layer at a
    time (``f32_streamed``).  A deep random model amplifies bf16 rounding
    past the serve phase's fixed 0.08, so the bf16 limit is measured, as
    for the prefills.  ``memory``: written into each cache (encdec, vlm).
    With a ``MoEProbe`` each step's dropped (token, slot) pairs are
    counted on the four runs, equal on the f32 kernel and plain paths."""
    from repro_torch.models.transformer import decode_step, init_cache

    dev = toks.device
    B = toks.shape[0]
    cfg32, p32 = f32_streamed(cfg, params)
    runs = [(params, cfg, False), (params, cfg, True), (p32, cfg32, False),
            (p32, cfg32, True)]
    mem_len = 0 if memory is None else memory.shape[1]
    caches = [init_cache(c, B, n_cmp, dev, mem_len=mem_len)
              for _, c, _ in runs]
    if memory is not None:
        for cache in caches:
            cache["memory"].copy_(memory)
    out = []
    with torch.inference_mode():
        for t in range(n_cmp):
            pos = torch.tensor(t, dtype=torch.int32, device=dev)
            logits, drops = [], []
            for (p, c, plain), cache in zip(runs, caches):
                def run():
                    return decode_step(p, c, cache, toks[:, t:t + 1], pos,
                                       plain=plain)[0]
                if probe is None:
                    logits.append(run())
                else:
                    lg, d = probe.run(run)
                    logits.append(lg)
                    drops.append(d)
            out.append(hold_kernel_path(torch, *logits, f"{what} step {t}"))
            if probe is not None:
                out[-1]["dropped_pairs"] = dict(zip(
                    ("bf16_kernel", "bf16_plain", "f32_kernel", "f32_plain"),
                    drops))
                check(drops[2] == drops[3], f"{what} step {t}: {drops[2]} "
                      f"pairs dropped on the f32 kernel path, {drops[3]} on "
                      f"the f32 plain path")
    return out


def gemma3_phase(torch, K, dev) -> dict:
    """gemma3-1b at full width and depth (26 layers in the 5:1 local /
    global program, hd 256, KV 1, window 512), random weights on the card:
    ``gemma3_prefill`` at B 1 x S 8192; ``gemma3_generate`` (B 4, 600 +
    32: the local layers' windows cut the last ~120 steps), then four
    teacher-forced kernel-vs-plain steps from position 600; and
    ``gemma3_long_decode``: one captured step against a 32768-key cache of
    random K / V at pos 32760, timed, its logits held against the plain
    path.  Returns the launches by path."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.transformer import decode_step
    from repro_torch.serve.step import CapturedServeStep

    cfg = get_config("gemma3-1b")
    torch.cuda.reset_peak_memory_stats()
    model, params, n_params, t_init = random_model(torch, cfg, dev)
    by_path = {"gemma3_prefill": run_prefill(
        torch, K, cfg, params, GEMMA3_PREFILL_SHAPE, "gemma3_prefill", 5,
        n_params=n_params, init_s=t_init,
        cut="S 8192 of the reference's prefill_32k: the forward "
            "materialises [B, S, 262144] logits, the f32 hold twice")}

    launches, toks, step, _ = dense_generate(
        torch, K, cfg, model, GEMMA3_GENERATE, "gemma3_generate", 6)
    by_path["gemma3_generate"] = launches
    # the kernel path against the plain path past the window: the captured
    # step rebuilds the prompt's cache teacher-forced, each path then steps
    # from a copy of it
    B, S0, _ = GEMMA3_GENERATE
    zero_cache(step)
    positions = torch.arange(S0, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for t in range(S0):
            step(toks[:, t:t + 1], positions[t])
    caches = [tree_map(lambda t: t.clone(), step.cache) for _ in range(2)]
    hold = hold_decode_steps(torch, cfg, params, toks, 4, dev,
                             "gemma3 generate", start=S0, caches=caches)
    emit("gemma3_generate_hold", arch=cfg.name, **hold)
    del step, caches
    torch.cuda.empty_cache()

    # one long step: 22 local layers read <= 512 keys, 4 global all of them
    B, S, pos = GEMMA3_LONG
    torch.cuda.reset_peak_memory_stats()
    reset_counts(K)
    long_step = CapturedServeStep(cfg, params, B, S, device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    for _, leaf in tree_leaves(long_step.cache):
        leaf.normal_(generator=g)
    plain_cache = tree_map(lambda t: t.clone(), long_step.cache)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), device=dev, generator=g)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        _, lk = long_step(tok, p)
        lk = lk.clone()
        lp, _ = decode_step(params, cfg, plain_cache, tok, p, plain=True)
        lp = lp.float()
        # the same step's kernels, eagerly (the replay runs these)
        prof = device_profile(
            torch, lambda: decode_step(params, cfg, plain_cache, tok, p),
            KERNELS)
    del plain_cache
    err = (lk - lp).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(lk.flatten(), lp.flatten(),
                                                dim=0).item()
    check(bool(torch.isfinite(lk).all()), "gemma3 long step: non-finite")
    check(torch.allclose(lk, lp, atol=0.08, rtol=0.05) and cos > 0.999,
          f"gemma3 long step: kernel vs plain logits differ by {err} "
          f"(cosine {cos})")
    reps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(reps):
            long_step(tok, p)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    check(long_step.launches["decode_attention"] == cfg.n_layers
          and long_step.launches["rmsnorm"] == 4 * cfg.n_layers + 1,
          f"gemma3 long step launches {long_step.launches}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_path["gemma3_long_decode"] = {
        k: n * (long_step.replays) for k, n in long_step.launches.items()}
    emit("gemma3_long_decode", arch=cfg.name, batch=B, cache_len=S, pos=pos,
         cut="batch 8 of the reference's decode_32k (128)",
         replay_ms_per_step=ms, reps=reps,
         device_busy_ms=prof["device_busy_ms"],
         device_idle_share=1.0 - prof["device_busy_ms"] / ms,
         port_kernels_ms=prof["port_kernels"], top_kernels=prof["top_kernels"],
         launches_per_step=long_step.launches, replays=long_step.replays,
         n_split=K.plan_splits(S, B * cfg.n_kv_heads, sms, hd=cfg.hd),
         plain_vs_kernel_max_abs_err=err, cosine=cos,
         plain_vs_kernel_tol={"atol": 0.08, "rtol": 0.05, "cosine_min": 0.999},
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del long_step, model, params
    torch.cuda.empty_cache()
    return by_path


def dense_large_phase(torch, K, dev, arch) -> dict:
    """qwen2.5-14b or nemotron-4-15b at full width and depth (29.54 / 31.26
    GB of bf16 weights drawn on the card): ``dense_large_prefill`` at B 1 x
    S 4096 (the f32 hold at full depth, its weights upcast one layer at a
    time), then ``dense_large_generate`` (B 4, 16 + 16) with four
    teacher-forced kernel-vs-plain steps.  Returns the launches by path."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    model, params, n_params, t_init = random_model(torch, cfg, dev)
    weights_peak = torch.cuda.max_memory_allocated()
    by_path = {f"{arch} prefill": run_prefill(
        torch, K, cfg, params, LARGE_PREFILL_SHAPE, "dense_large_prefill", 8,
        streamed=True, n_params=n_params, init_s=t_init,
        init_max_memory_allocated=weights_peak)}
    launches, toks, step, _ = dense_generate(
        torch, K, cfg, model, LARGE_GENERATE, "dense_large_generate", 9)
    by_path[f"{arch} generate"] = launches
    del step
    emit("dense_large_generate_hold", arch=cfg.name,
         plain_vs_kernel=hold_decode_kernel_path(torch, cfg, params, toks, 4,
                                                 f"{arch} decode"))
    del model, params
    torch.cuda.empty_cache()
    return by_path


# ------------------------------------------------------- serving families

def set_nonzero_inits(torch, cfg, params, seed: int) -> list:
    """Every parameter leaf whose init is ``zeros`` set to a fixed nonzero
    value, so that the path it gates or shifts takes part: each VLM
    cross-attention ``gate`` to ``GATE_VALUE`` (``tanh(0) = 0`` would make
    every cross-attention layer add exactly nothing), the others (LayerNorm
    ``bias``, the mLSTM's ``b_if``, the sLSTM's ``b``) to 0.2 x a standard
    normal draw from a seeded generator.  Returns their keys."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import model_specs

    flat = dict(tree_leaves(params))
    keys = [k for k, spec in tree_leaves(model_specs(cfg))
            if spec.init == "zeros"]
    g = torch.Generator(device=params["embed"].device).manual_seed(seed)
    with torch.no_grad():
        for k in keys:
            t = flat[k]
            if k.endswith("/gate"):
                t.fill_(GATE_VALUE)
            else:
                t.copy_(torch.randn(t.shape, generator=g, device=t.device)
                        * 0.2)
    return keys


class MoEProbe:
    """Wraps the port's MoE router (``moe._gates``) and slot assignment
    (``moe._slots``) while entered (``with probe.pin(...)``), or for the
    length of one call.  ``run(fn)`` counts the (token, slot) pairs that
    ``fn``'s MoE blocks drop past capacity; ``run(fn, record=True)`` also
    returns the expert choice of every router call, and ``run(fn,
    replay=choices)`` makes ``fn``'s routers take those choices (each
    weighted by its own renormalised probability there) and counts the
    (token, slot) entries where its own choice differed.  An a2a rank's
    router sees its own rows of the batch: it takes its rows of a choice
    (``ShardingCtx.batch_shard``).  The smoke uses the replay to hold a
    kernel path that has no f32 copy to measure a floor against, and a
    layout of ranks against one rank (``pin``): bf16 rounding in a
    different order (a sum over ``model``, a GEMM of other rows)
    reorders near-tied experts, and one reordered expert moves a token by
    O(1)."""

    def __init__(self, torch, moe):
        self.torch, self.moe = torch, moe
        self.dropped, self.flips = [], []
        self.recorded = self.replay = None
        #: set to E / M while an a2a path runs: its second bucketing has a
        #: class E / M for empty slots, which are not pairs
        self.empty = None

    def _slots(self, gate_idx, n_experts, cap):
        row, keep = self.slots(gate_idx, n_experts, cap)
        if self.empty is not None and n_experts == self.empty + 1:
            keep = keep | (gate_idx == self.empty)
        self.dropped.append((~keep).sum())
        return row, keep

    def _gates(self, cfg, xt, router, *rest):
        vals, idx, lb = self.gates(cfg, xt, router, *rest)
        if self.recorded is not None:
            self.recorded.append(idx)
        if self.replay is not None:
            pin = self.replay.pop(0).to(idx.device)
            if pin.shape[0] != idx.shape[0]:
                from repro_torch.distributed.context import active_ctx

                i, n = active_ctx().batch_shard()[0], idx.shape[0]
                pin = pin[i * n:(i + 1) * n]
            self.flips.append((pin != idx).sum())
            probs = self.torch.softmax(xt.float() @ router.float(), dim=-1)
            vals = probs.gather(1, pin)
            vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
            idx = pin
        return vals, idx, lb

    def pin(self, *, record=False, replay=None) -> "MoEProbe":
        """This probe, set to record the choices or to take ``replay``'s
        (and to count drops and flips afresh) in its next ``with``."""
        self.dropped, self.flips = [], []
        self.recorded = [] if record else None
        self.replay = None if replay is None else list(replay)
        return self

    def __enter__(self):
        self.gates, self.slots = self.moe._gates, self.moe._slots
        self.moe._gates, self.moe._slots = self._gates, self._slots
        return self

    def __exit__(self, *exc):
        self.moe._gates, self.moe._slots = self.gates, self.slots

    def n_flips(self) -> int:
        return int(sum(int(f) for f in self.flips))

    def run(self, fn, *, record=False, replay=None):
        with self.pin(record=record, replay=replay):
            out = fn()
        recorded, self.recorded, self.replay = self.recorded, None, None
        dropped = int(sum(int(d) for d in self.dropped))
        if record:
            return (out, dropped), recorded
        if replay is not None:
            return (out, dropped), self.n_flips()
        return out, dropped


def _pinned(torch, replay=None) -> "MoEProbe":
    """A ``MoEProbe`` set to record the routing (no ``replay``) or to take
    ``replay``'s, for a ``with`` around a run."""
    from repro_torch.models import moe

    return MoEProbe(torch, moe).pin(record=replay is None, replay=replay)


def hold_fixed(torch, lk, lp, what: str) -> dict:
    """Kernel-path logits against plain-path logits at the decode-step
    tolerance: atol 0.08, rtol 0.05, cosine > 0.999."""
    lk, lp = lk.float(), lp.float()
    check(bool(torch.isfinite(lk).all()), f"{what}: non-finite logits")
    err = (lk - lp).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(lk.flatten(), lp.flatten(),
                                                dim=0).item()
    check(torch.allclose(lk, lp, atol=0.08, rtol=0.05) and cos > 0.999,
          f"{what}: kernel vs plain logits differ by {err} (cosine {cos})")
    return {"bf16_max_abs_err": err, "bf16_cosine": cos,
            "bf16_tol": {"atol": 0.08, "rtol": 0.05, "cosine_min": 0.999},
            "bf16_argmax_agree": (lk.argmax(-1) == lp.argmax(-1)).float()
            .mean().item()}


def family_model(torch, cfg, dev):
    """``random_model`` with the zero-init leaves set nonzero; the memory
    still allocated before the draw (what earlier phases left, after a
    collection) is reported with it."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model, params, n_params, t_init = random_model(torch, cfg, dev)
    nonzero = set_nonzero_inits(torch, cfg, params, 11)
    return model, params, dict(n_params=n_params, init_s=t_init,
                               nonzero_init_leaves=nonzero,
                               memory_allocated_before_init=before,
                               init_max_memory_allocated=torch.cuda
                               .max_memory_allocated())


def xlstm_phase(torch, K, dev) -> dict:
    """xlstm-125m at full width and depth (6 x (mLSTM, sLSTM), d 768):
    ``xlstm_prefill`` at B 1 x S 256 (13 rmsnorm launches per forward: no
    other kernel runs; the cells' loops over time are host-bound, timed
    once, with a kernels-only profile), ``xlstm_generate`` (B 4, 16 + 32)
    with four teacher-forced kernel-vs-plain steps, and one captured step
    at position 524,287 (the reference's ``long_500k``: the state has no
    sequence axis), held against the plain path.  Returns the launches by
    path."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.models.transformer import decode_step
    from repro_torch.serve.step import CapturedServeStep

    cfg = get_config("xlstm-125m")
    model, params, info = family_model(torch, cfg, dev)
    per = {"rmsnorm": cfg.n_layers + 1, "flash_attention": 0,
           "decode_attention": 0, "ssm_scan": 0}
    by_path = {"xlstm_prefill": run_prefill(
        torch, K, cfg, params, XLSTM_PREFILL_SHAPE, "xlstm_prefill", 21,
        per_fwd=per, reps=1, profile_seq=XLSTM_PROFILE_SEQ, **info)}
    launches, toks, step, _ = dense_generate(
        torch, K, cfg, model, XLSTM_GENERATE, "xlstm_generate", 22,
        per_step=per,
        plain_vs_kernel=hold_decode_kernel_path(
            torch, cfg, params, prompt_for(torch, cfg, XLSTM_GENERATE, dev,
                                           22), 4, "xlstm decode"))
    by_path["xlstm_generate"] = launches
    del step

    # one step at the long_500k position, from a state built over a prompt
    reset_counts(K)
    long_step = CapturedServeStep(cfg, params, 1, XLSTM_LONG_POS + 1,
                                  device=dev)
    S0 = XLSTM_GENERATE[1]
    positions = torch.arange(S0, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        for t in range(S0):
            long_step(toks[:1, t:t + 1], positions[t])
    plain_cache = tree_map(lambda t: t.clone(), long_step.cache)
    tok = toks[:1, S0:S0 + 1]
    p = torch.tensor(XLSTM_LONG_POS, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        _, lk = long_step(tok, p)
        lk = lk.clone()
        lp, _ = decode_step(params, cfg, plain_cache, tok, p, plain=True)
        hold = hold_fixed(torch, lk, lp, "xlstm long step")
        reps = 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            long_step(tok, p)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        prof = device_profile(
            torch, lambda: decode_step(params, cfg, plain_cache, tok, p),
            KERNELS)
    check(long_step.launches == {**per, **dict.fromkeys(MESH_KERNELS, 0)},
          f"xlstm long step {long_step.launches}")
    state_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_leaves(long_step.cache))
    by_path["xlstm_long_decode"] = {k: n * long_step.replays
                                    for k, n in long_step.launches.items()}
    emit("xlstm_generate", part="long_500k step", arch=cfg.name, batch=1,
         pos=XLSTM_LONG_POS, replay_ms_per_step=ms, reps=reps,
         tokens_per_s=1e3 / ms, cache_state_bytes=state_bytes,
         device_busy_ms=prof["device_busy_ms"],
         device_idle_share=1.0 - prof["device_busy_ms"] / ms,
         launches_per_step=long_step.launches, replays=long_step.replays,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         plain_vs_kernel=hold)
    del long_step, model, params
    torch.cuda.empty_cache()
    return by_path


def moe_phase(torch, K, dev) -> dict:
    """olmoe-1b-7b at full width and depth (16 layers, E 64, top 8,
    qk-norm): ``moe_prefill`` at B 1 x S 4096 (capacity 640 per expert),
    held at bf16 and with the whole model in f32, the dropped (token, slot)
    pairs of each hold run counted; ``moe_generate`` (B 4, 16 + 16;
    capacity 1 per expert, so pairs of the batch that share an expert
    drop), four teacher-forced kernel-vs-plain steps with their drops.
    Returns the launches by path."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("olmoe-1b-7b")
    model, params, info = family_model(torch, cfg, dev)
    probe = MoEProbe(torch, moe)
    by_path = {"moe_prefill": run_prefill(
        torch, K, cfg, params, MOE_PREFILL_SHAPE, "moe_prefill", 31,
        probe=probe, capacity=moe.capacity(cfg, math.prod(
            MOE_PREFILL_SHAPE)), **info)}
    B = MOE_GENERATE[0]
    hold = hold_decode_kernel_path(
        torch, cfg, params, prompt_for(torch, cfg, MOE_GENERATE, dev, 32), 4,
        "olmoe decode", probe=probe)
    launches, _, step, _ = dense_generate(
        torch, K, cfg, model, MOE_GENERATE, "moe_generate", 32,
        capacity=moe.capacity(cfg, B), plain_vs_kernel=hold)
    by_path["moe_generate"] = launches
    del step, model, params
    torch.cuda.empty_cache()
    return by_path


def kimi_phase(torch, K, dev) -> dict:
    """One kimi-k2 layer at full width (d 7168, E 384, top 8, H 64 / KV 8,
    hd 112, vocab 163,840; ``n_layers`` cut 61 -> 1: 36.4 GB of the model's
    2.08 TB): ``moe_kimi_layer`` prefill at B 1 x S 2048 and the captured
    step (B 4, 16 + 16).  An f32 copy does not fit beside the bf16 one, so
    the holds are bf16 at the decode-step tolerance, the kernel path routed
    as the plain path chose (``MoEProbe``; the differing choices are
    counted).  Returns the launches by path."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.transformer import decode_step, init_cache

    cfg = get_config("kimi-k2-1t-a32b").replace(n_layers=KIMI_LAYERS)
    model, params, info = family_model(torch, cfg, dev)
    cut = (f"n_layers 61 -> {KIMI_LAYERS}: the model's 2.08 TB of bf16 "
           f"weights do not fit one card")
    probe = MoEProbe(torch, moe)
    by_path = {"kimi prefill": run_prefill(
        torch, K, cfg, params, KIMI_PREFILL_SHAPE, "moe_kimi_layer", 41,
        probe=probe, pinned=True, part="prefill", cut=cut,
        capacity=moe.capacity(cfg, math.prod(KIMI_PREFILL_SHAPE)), **info)}
    B = KIMI_GENERATE[0]
    prompt = prompt_for(torch, cfg, KIMI_GENERATE, dev, 42)
    ck, cp = (init_cache(cfg, B, 4, dev) for _ in range(2))
    hold = []
    with torch.inference_mode():
        for t in range(4):
            pos = torch.tensor(t, dtype=torch.int32, device=dev)
            tok = prompt[:, t:t + 1]
            (lp, dp), rec = probe.run(lambda: decode_step(
                params, cfg, cp, tok, pos, plain=True)[0], record=True)
            (lk, dk), flips = probe.run(lambda: decode_step(
                params, cfg, ck, tok, pos)[0], replay=rec)
            check(dk == dp, f"kimi decode step {t}: {dk} pairs dropped on "
                  f"the kernel path, {dp} on the plain path")
            hold.append({**hold_fixed(torch, lk, lp, f"kimi decode step {t}"),
                         "dropped_pairs": {"bf16_kernel": dk,
                                           "bf16_plain": dp},
                         "routing_flips_pinned": flips})
    del ck, cp
    launches, _, step, _ = dense_generate(
        torch, K, cfg, model, KIMI_GENERATE, "moe_kimi_layer", 42,
        part="generate", cut=cut, capacity=moe.capacity(cfg, B),
        plain_vs_kernel=hold, routing_pinned_to_plain=True)
    by_path["kimi generate"] = launches
    del step, model, params
    torch.cuda.empty_cache()
    return by_path


def stub_inputs(torch, cfg, B, n, dev, seed):
    """The stub frontend's input: ``[B, n, frontend_dim]`` frames (encdec)
    or patches (vlm), standard normal from a seeded generator."""
    key = "frames" if cfg.family == "encdec" else "patches"
    return {key: torch.randn((B, n, cfg.frontend_dim), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(seed))}


def cross_family_phase(torch, K, dev, arch) -> dict:
    """whisper-large-v3 (``encdec_*``: 32 encoder + 32 decoder layers,
    LayerNorm, GELU, no RoPE) or llama-3.2-vision-11b (``vlm_*``: 8 x (4
    attn + 1 gated cross-attention), gates at ``GATE_VALUE``) at full
    width and depth.  Prefill: whisper over B 1 x 1500 frames and 448
    tokens (flash: 32 bidirectional at 1500 x 1500, 32 causal, 32 cross
    at 448 x 1500; the plain hold's attention takes the whole 1500-frame
    encoder sequence as one query block: the reference's blocked form
    needs a multiple of its 1024), llama-vision over B 1 x 1024 patches
    and S 2048 (its f32 hold upcast one group at a time).  Generate: B 4
    against the model's own memory (whisper: its encoder's output over 4 x
    1500 frames; llama-vision: 4 x 1024 projected patches), every cross-
    attention's one query through decode_attention at pos M - 1; four
    teacher-forced kernel-vs-plain steps against that memory.  Returns the
    launches by path."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import encode

    cfg = get_config(arch)
    model, params, info = family_model(torch, cfg, dev)
    L = cfg.n_layers
    if cfg.family == "encdec":
        name, (B1, S), n_mem = "encdec", (1, WHISPER_TOKENS), WHISPER_FRAMES
        gen_shape, streamed = ENCDEC_GENERATE, False
        per_fwd = {"flash_attention": cfg.n_encoder_layers + 2 * L,
                   "rmsnorm": 0, "decode_attention": 0, "ssm_scan": 0}
        per_step = {"decode_attention": 2 * L, "rmsnorm": 0,
                    "flash_attention": 0, "ssm_scan": 0}
        q_block = WHISPER_FRAMES
    else:
        name, (B1, S), n_mem = "vlm", VLM_PREFILL_SHAPE, VLM_PATCHES
        gen_shape, streamed = VLM_GENERATE, True
        per_fwd = per_step = None          # L flash / decode, 2 L + 1 norms
        q_block = 1024
    by_path = {f"{name}_prefill": run_prefill(
        torch, K, cfg, params, (B1, S), f"{name}_prefill", 51,
        inputs=stub_inputs(torch, cfg, B1, n_mem, dev, 52), per_fwd=per_fwd,
        streamed=streamed, plain_q_block=q_block, memory_rows=n_mem, **info)}
    B = gen_shape[0]
    with torch.inference_mode():
        memory = encode(params, cfg, stub_inputs(torch, cfg, B, n_mem, dev,
                                                 53))
    check(tuple(memory.shape) == (B, n_mem, cfg.d_model)
          and bool(torch.isfinite(memory.float()).all()),
          f"{arch}: memory {tuple(memory.shape)}")
    hold = hold_decode_kernel_path(
        torch, cfg, params, prompt_for(torch, cfg, gen_shape, dev, 54), 4,
        f"{arch} decode", memory=memory)
    launches, _, step, _ = dense_generate(
        torch, K, cfg, model, gen_shape, f"{name}_generate", 54,
        per_step=per_step, memory=memory, memory_rows=n_mem,
        memory_from="the encoder over 1500 frames" if name == "encdec"
        else "1024 projected patches", plain_vs_kernel=hold)
    by_path[f"{name}_generate"] = launches
    del step, model, params, memory
    torch.cuda.empty_cache()
    return by_path


# ------------------------------------------------------------------ training

def grad_of(torch, fn, inputs, cot):
    """``(out, grads)`` of ``fn(*inputs)`` against ``cot``, each input a
    fresh leaf that requires grad."""
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    return out.detach(), list(torch.autograd.grad(out, ins, cot))


def hold_grads(torch, gk, gp, gk32, gp32, names, what: str) -> dict:
    """Gradients of the kernel path (``gk``; the f32 run ``gk32``) against
    the plain path's (``gp``, ``gp32``), leaf by leaf.  f32: within atol =
    rtol = 1e-2 and at cosine > 0.9999.  bf16: within twice the plain
    path's own distance from its f32 gradient, in max abs error and in
    angle (``hold_kernel_path``'s triangle bound; a leaf whose bf16 and f32
    plain gradients agree exactly allows 1e-6 of its largest entry).
    Every kernel-path gradient finite and nonzero: a kernel that cut the
    graph would leave its inputs with none."""
    out = {}
    for name, a, b, a32, b32 in zip(names, gk, gp, gk32, gp32):
        a, b, a32, b32 = (t.float() for t in (a, b, a32, b32))
        for tag, t in (("bf16", a), ("f32", a32)):
            check(bool(torch.isfinite(t).all()) and t.abs().max() > 0,
                  f"{what} {name}: {tag} kernel-path gradient non-finite "
                  f"or zero")
        err32 = (a32 - b32).abs().max().item()
        cos32 = torch.nn.functional.cosine_similarity(
            a32.flatten(), b32.flatten(), dim=0).item()
        check(torch.allclose(a32, b32, atol=1e-2, rtol=1e-2)
              and cos32 > 0.9999, f"{what} {name}: f32 gradients differ by "
              f"{err32} (cosine {cos32})")
        floor = (b - b32).abs().max().item()
        err = (a - b).abs().max().item()
        slack = 1e-6 * b32.abs().max().item()
        ang_floor, ang = _angle(torch, b, b32), _angle(torch, a, b)
        check(err <= 2 * floor + slack, f"{what} {name}: bf16 gradients "
              f"differ by {err}, over twice the bf16 floor {floor}")
        check(ang <= 2 * ang_floor + 1e-6, f"{what} {name}: bf16 gradients "
              f"at angle {ang}, over twice the floor {ang_floor}")
        out[name] = {"f32_max_abs_err": err32, "f32_cosine": cos32,
                     "bf16_max_abs_err": err, "bf16_floor_max_abs": floor,
                     "bf16_angle": ang, "bf16_floor_angle": ang_floor}
    return out


def kernel_grad_hold(torch, K, dev, label, kernel, plain, inputs, cot,
                     names, low, library=None, bound=None) -> dict:
    """One kernel's gradients against its plain version's: at bf16
    (``inputs`` as given; the f32 reference upcasts those at index in
    ``low``) and at f32 (every input f32).  Then one forward + backward
    at bf16 timed on the kernel path, the plain path and, where one
    PyTorch call computes the function (``library``), through it, beside
    ``bound`` ((bytes, flops) of one forward and backward) as a time.
    Returns the hold, the timings and the kernel's launches (one per
    kernel-path call of the holds; the timed calls are not counted)."""
    up = [t.float() if i in low else t for i, t in enumerate(inputs)]
    before = counts(K)
    _, gk = grad_of(torch, kernel, inputs, cot)
    _, gk32 = grad_of(torch, kernel, up, cot.float())
    after = counts(K)
    _, gp = grad_of(torch, plain, inputs, cot)
    _, gp32 = grad_of(torch, plain, up, cot.float())
    check(counts(K) == after, f"{label}: the plain path launched a kernel")
    hold = hold_grads(torch, gk, gp, gk32, gp32, names, label)
    del gk, gk32, gp, gp32
    timing = {"kernel_fwd_bwd_ms": fwd_bwd_ms(torch, kernel, inputs, cot),
              "plain_fwd_bwd_ms": fwd_bwd_ms(torch, plain, inputs, cot),
              "library_fwd_bwd_ms": None if library is None else
              fwd_bwd_ms(torch, library, inputs, cot)}
    if bound is not None:
        timing["bound_fwd_bwd_ms"], timing["bound_fwd_bwd_by"] = bound_ms(
            *bound, "bfloat16")
    return {"hold": hold, "timing": timing,
            "launches": {k: after[k] - before[k] for k in KERNELS}}


def fwd_bwd_ms(torch, fn, inputs, cot, iters: int = 5) -> float:
    """Device-clock ms of one forward and backward of ``fn``."""
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]

    def once():
        torch.autograd.grad(fn(*ins), ins, cot)

    once()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        once()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def train_kernel_grads(torch, K, dev) -> tuple:
    """``train_grad_hold`` part 1: flash_attention, rmsnorm (with and
    without residual) and ssm_scan, kernel path against plain path, at
    the training path's shapes, each forward + backward timed beside the
    plain path's and a library call's (SDPA, ``F.rms_norm``; none for the
    SSD scan).  Returns (holds, launches)."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(77)

    def randn(shape, dt=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dt)

    holds, launches = {}, {k: 0 for k in KERNELS}

    def add(label, r):
        holds[label] = {**r["hold"], "timing": r["timing"]}
        for k, n in r["launches"].items():
            launches[k] += n

    for label, B, Sq, Sk, H, KV, hd, causal, window in GRAD_FLASH_SHAPES:
        q, k, v = (randn((B, Sq, H, hd)), randn((B, Sk, KV, hd)),
                   randn((B, Sk, KV, hd)))
        cot = randn((B, Sq, H, hd))
        kw = dict(causal=causal, window=window)

        def sdpa(q, k, v, causal=causal, window=window):
            mask = None
            if window is not None:      # SDPA has no window: a bool mask
                qp = torch.arange(q.shape[1], device=dev)[:, None]
                kp = torch.arange(k.shape[1], device=dev)[None, :]
                mask = (kp <= qp) & (kp > qp - window)
            o = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=True)
            return o.transpose(1, 2)

        add(f"flash {label}", kernel_grad_hold(
            torch, K, dev, f"flash {label}",
            lambda *t, kw=kw: K.flash_attention(*t, **kw),
            lambda *t, kw=kw: K.flash_attention_plain(*t, **kw), [q, k, v],
            cot, ["dq", "dk", "dv"], {0, 1, 2}, library=sdpa,
            bound=flash_fwd_bwd_bound(B, Sq, Sk, H, KV, hd, causal, window)))
        del q, k, v, cot
    for rows, d in GRAD_RMSNORM_SHAPES:
        for res in (False, True):
            x = randn((rows, d))
            scale = randn((d,), scale=0.1) + 1.0
            ins = [x, scale] + ([randn((rows, d))] if res else [])
            names = ["dx", "dscale"] + (["dresidual"] if res else [])
            add(f"rmsnorm ({rows}, {d}){' + residual' if res else ''}",
                kernel_grad_hold(
                    torch, K, dev, f"rmsnorm {rows}x{d}",
                    lambda x, s, *r: K.rmsnorm(x, s, *r),
                    lambda x, s, *r: K.rmsnorm_plain(x, s, *r), ins,
                    randn((rows, d)), names, set(range(len(ins))),
                    library=lambda x, s, *r: F.rms_norm(
                        x + r[0] if r else x, (x.shape[-1],), s, 1e-6)))
    B, S, H, P, N = GRAD_SSM_SHAPE
    ins = [randn((B, S, H, P)),
           torch.rand((B, S, H), generator=gen, device=dev) * 0.1 + 0.01,
           -(torch.rand((H,), generator=gen, device=dev) + 0.5),
           randn((B, S, N), scale=0.5), randn((B, S, N), scale=0.5)]
    kw = dict(chunk=128, out_dtype=torch.float32)
    add(f"ssm_scan zamba2 B {B} S {S} H {H}", kernel_grad_hold(
        torch, K, dev, "ssm_scan", lambda *t: K.ssm_scan(*t, **kw),
        lambda *t: K.ssm_scan_plain(*t, **kw), ins,
        randn((B, S, H, P), torch.float32), ["dx", "ddt", "dA", "dB", "dC"],
        {0, 3, 4}, bound=ssm_fwd_bwd_bound(B, S, H, P, N, kw["chunk"])))
    return holds, launches


def lm_grads(torch, cfg, params, batch, plain: bool) -> tuple:
    """``(loss, [grad per leaf])`` of ``lm_loss`` (leaves in key order)."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import lm_loss
    from repro_torch.weights import unflatten

    keys, leaves = zip(*tree_leaves(params))
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    loss = lm_loss(unflatten(dict(zip(keys, leaves))), cfg, batch,
                   plain=plain)
    return loss.item(), list(torch.autograd.grad(loss, leaves))


def train_model_grads(torch, K, dev, arch) -> tuple:
    """``train_grad_hold`` part 2: per-leaf gradients of ``lm_loss`` at
    full width (qwen3-1.7b at GRAD_MODEL_LAYERS layers, zamba2-7b at one
    hybrid period), kernel path against plain path at bf16 and with the
    weights in f32, under the config's ``remat`` ("full"): every kernel of
    the stack launches twice (forward and recompute), the final norm
    once.  Returns (emitted fields, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import init_params, tree_leaves, tree_map
    from repro_torch.models.transformer import model_specs, program_for

    cfg = get_config(arch)
    L = cfg.hybrid_period if cfg.family == "hybrid" else GRAD_MODEL_LAYERS
    cfg = cfg.replace(n_layers=L)
    params = init_params(model_specs(cfg),
                         torch.Generator(device=dev).manual_seed(21),
                         cfg.torch_dtype, dev)
    B, S = GRAD_MODEL_SHAPE
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, S), device=dev,
        generator=torch.Generator(device=dev).manual_seed(22))}
    grp, n_groups, rem = program_for(cfg)
    n_attn = n_groups * sum(k in ("attn", "shared_attn") for k in grp)
    n_ssm = n_groups * grp.count("mamba") + rem.count("mamba")
    norms = n_attn * (4 if cfg.qk_norm else 2) + n_ssm
    twice = 2 if cfg.remat == "full" else 1
    want = {"flash_attention": twice * n_attn, "ssm_scan": twice * n_ssm,
            "rmsnorm": twice * norms + 1, "decode_attention": 0}
    reset_counts(K)
    lk, gk = lm_grads(torch, cfg, params, batch, plain=False)
    launches = counts(K)
    for name, n in want.items():
        check(launches[name] == n, f"train_grad_hold {arch}: {name} "
              f"launched {launches[name]} times, expected {n}")
    lp, gp = lm_grads(torch, cfg, params, batch, plain=True)
    cfg32 = cfg.replace(dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    del params
    lk32, gk32 = lm_grads(torch, cfg32, p32, batch, plain=False)
    lp32, gp32 = lm_grads(torch, cfg32, p32, batch, plain=True)
    check(counts(K)["flash_attention"] == 2 * want["flash_attention"],
          f"train_grad_hold {arch}: launches of the f32 run")
    names = [k for k, _ in tree_leaves(p32)]
    del p32
    hold = hold_grads(torch, gk, gp, gk32, gp32, names, f"{arch} lm_loss")
    for what, a in (("bf16", lk), ("f32", lk32)):
        check(math.isfinite(a), f"{arch}: {what} loss {a}")
    worst = {"f32_max_abs_err": max(h["f32_max_abs_err"]
                                   for h in hold.values()),
             "f32_min_cosine": min(h["f32_cosine"] for h in hold.values()),
             "bf16_max_err_over_floor": max(
                 h["bf16_max_abs_err"] / max(h["bf16_floor_max_abs"], 1e-30)
                 for h in hold.values())}
    fields = {"arch": arch, "n_layers": L, "batch": B, "seq": S,
              "remat": cfg.remat, "leaves": len(names),
              "loss": {"bf16_kernel": lk, "bf16_plain": lp,
                       "f32_kernel": lk32, "f32_plain": lp32},
              "launches_per_grad": launches, "worst": worst,
              "per_leaf": hold}
    del gk, gp, gk32, gp32
    torch.cuda.empty_cache()
    return fields, counts(K)


def train_grad_phase(torch, K, dev) -> dict:
    """``train_grad_hold``: gradients through the kernels against the
    plain path's, per kernel and per model.  Returns the launches."""
    reset_counts(K)
    holds, launches = train_kernel_grads(torch, K, dev)
    emit("train_grad_hold", part="kernels", tolerance={
        "f32": "atol = rtol = 1e-2, cosine > 0.9999",
        "bf16": "max abs err <= 2 x plain bf16 vs f32, angle <= 2 x its "
                "angle"}, holds=holds, launches=launches,
        backward="plain VJP (recomputed; flash in query blocks of "
                 "BWD_Q_BLOCK)")
    torch.cuda.empty_cache()
    for arch in ("qwen3-1.7b", "zamba2-7b"):
        fields, n = train_model_grads(torch, K, dev, arch)
        emit("train_grad_hold", part="model", **fields)
        for k in KERNELS:
            launches[k] += n[k]
    return launches


def train_profile(torch, fn) -> dict:
    """Device time of one call of ``fn`` (a train step) by kernel, and the
    device time under each kernel Function's backward node (the plain
    VJPs), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and dev_us(e) > 0]
    top = sorted(kernels, key=dev_us, reverse=True)[:10]

    def under(node: str) -> float:
        # the autograd node's inclusive device time (the kernels its
        # backward launched)
        return max((getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0))
                    for e in events if node in e.key), default=0.0) / 1e3

    return {"device_busy_ms": sum(dev_us(e) for e in kernels) / 1e3,
            "top_kernels": [{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                             "calls": e.count} for e in top],
            "port_kernels_ms": {n: sum(dev_us(e) for e in kernels
                                       if n in e.key and "kernel" in e.key)
                                / 1e3 for n in KERNELS},
            "backward_ms": {"flash_attention": under(
                                "FlashAttentionFnBackward"),
                            "rmsnorm": under("RMSNormFnBackward"),
                            "ssm_scan": under("SSMScanFnBackward")}}


def train_phase(torch, K, cfg, dev, params) -> dict:
    """``train``: qwen3-1.7b at full size trains from the restored weights
    through ``run_training`` (its MultiSourcePipeline over three throttled
    loopback mirrors, B 4 x S 2048 batches), TRAIN_STEPS steps; every loss
    finite, the launches per step exact (with ``remat="full"`` each flash
    and rmsnorm call of the stack runs twice, the final norm once); then
    TRAIN_REPEAT steps on one batch, whose last loss must be below its
    first, and one of them profiled.  Returns the training run's
    launches."""
    from repro_torch.launch.train import run_training
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step

    B, S = TRAIN_SHAPE
    L = cfg.n_layers
    twice = 2 if cfg.remat == "full" else 1
    per_step = {"flash_attention": twice * L,
                "rmsnorm": twice * 4 * L + 1,     # ln1, ln2, q/k-norm; final
                "decode_attention": 0, "ssm_scan": 0}
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts(K)
    secs = []
    state, losses = run_training(cfg, TRAIN_STEPS, B, S, device=dev,
                                 params=params, step_seconds=secs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = counts(K)
    for name, n in per_step.items():
        check(launches[name] == n * TRAIN_STEPS,
              f"train {name}: {launches[name]} launches, expected {n} x "
              f"{TRAIN_STEPS}")
    check(all(math.isfinite(x) for x in losses), f"train losses {losses}")

    opt = AdamWConfig(lr=3e-4, warmup_steps=1, decay_steps=10_000)
    step_fn = make_train_step(cfg, opt)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, S), device=dev,
        generator=torch.Generator(device=dev).manual_seed(31))}
    repeat = []
    for _ in range(TRAIN_REPEAT):
        state, m = step_fn(state, batch)
        repeat.append(m["loss"].item())
    check(all(math.isfinite(x) for x in repeat) and repeat[-1] < repeat[0],
          f"train: losses on one repeated batch {repeat} do not fall")
    holder = {}

    def one_step():
        holder["state"], _ = step_fn(state, batch)

    prof = train_profile(torch, one_step)
    del holder
    warm = sorted(secs[2:])
    ms = warm[len(warm) // 2] * 1e3
    tokens = B * S
    flops = 6 * n_params * tokens
    emit("train", arch=cfg.name, n_layers=L, d_model=cfg.d_model,
         params=n_params, batch=B, seq=S, remat=cfg.remat,
         steps=TRAIN_STEPS, losses=losses, step_s=secs,
         ms_per_step_warm=ms, tokens_per_s=tokens / (ms / 1e3),
         model_flops_per_step=flops, model_flops_rule="6 N T (attention "
         "scores and the remat recompute not counted)",
         model_tflops_per_s=flops / (ms / 1e3) / 1e12,
         model_flops_share_of_bf16_peak=flops / (ms / 1e3) / BF16_PEAK,
         bound_ms_8nt=8 * n_params * tokens / BF16_PEAK * 1e3,
         max_memory_allocated=peak, memory_before_run=base,
         repeated_batch_losses=repeat, launches=launches,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         device_busy_ms=prof["device_busy_ms"],
         device_idle_share=1.0 - prof["device_busy_ms"] / ms,
         backward_ms=prof["backward_ms"],
         flash_backward_share_of_busy=prof["backward_ms"]["flash_attention"]
         / prof["device_busy_ms"],
         port_kernels_ms=prof["port_kernels_ms"],
         top_kernels=prof["top_kernels"])
    del state
    torch.cuda.empty_cache()
    return launches


def train_resume_phase(torch, K, cfg, dev) -> dict:
    """``train_resume``: qwen3-1.7b at full width with 2 layers, 4 steps
    with a ``CheckpointManager(every_steps=2)``; the step-2 train state
    restored onto the card with ``restore_checkpoint`` must be bit-exact
    to the state saved, and steps 2-3 run again from it must give the
    uninterrupted run's losses (within 1e-3 relative; whether they are bit
    for bit is printed) with ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: the embedding and gather backwards accumulate by
    index."""
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.models.common import init_params, tree_leaves, tree_map
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = cfg.replace(n_layers=GRAD_MODEL_LAYERS)
    B, S = RESUME_SHAPE
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, decay_steps=4)
    gen = torch.Generator(device=dev).manual_seed(41)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                        device=dev, generator=gen)}
               for _ in range(4)]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    reset_counts(K)
    try:
        state = init_train_state(init_params(
            model_specs(cfg), torch.Generator(device=dev).manual_seed(42),
            cfg.torch_dtype, dev), opt)
        step_fn = make_train_step(cfg, opt)
        mgr = CheckpointManager(tmp, every_steps=2, keep=3)
        losses, saved = [], None
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            state, m = step_fn(state, b)
            losses.append(m["loss"].item())
            if i + 1 == 2:
                saved = {k: t.detach().clone()
                         for k, t in tree_leaves(state)}
            mgr.maybe_save(i + 1, state)
        mgr.wait()
        run_s = time.perf_counter() - t0
        del state
        t0 = time.perf_counter()
        restored, step = restore_checkpoint(tmp, _train_like(cfg, opt),
                                            step=2, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(step == 2, f"train_resume: restored step {step}")
        leaves = check_bit_exact(torch, saved, restored, "train_resume")
        del saved
        restored["params"] = tree_map(lambda t: t.requires_grad_(True),
                                      restored["params"])
        rerun = []
        for b in batches[2:]:
            restored, m = make_train_step(cfg, opt)(restored, b)
            rerun.append(m["loss"].item())
        del restored
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = counts(K)
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "rmsnorm": 2 * 4 * cfg.n_layers + 1}
    for name, n in per_step.items():
        check(launches[name] == n * 6, f"train_resume {name}: "
              f"{launches[name]} launches, expected {n} x 6")
    rel = max(abs(a - b) / abs(b) for a, b in zip(rerun, losses[2:]))
    check(rel <= 1e-3, f"train_resume: re-run losses {rerun} against "
          f"{losses[2:]}")
    emit("train_resume", arch=cfg.name, n_layers=cfg.n_layers, batch=B,
         seq=S, losses=losses, rerun_losses=rerun, bit_equal=rerun ==
         losses[2:], max_rel_diff=rel, tolerance_rel=1e-3,
         deterministic_algorithms="on (warn_only)", restored_leaves=leaves,
         state_bit_exact=True, run_s=run_s, restore_s=restore_s,
         launches=launches)
    torch.cuda.empty_cache()
    return launches


def _vector_dist(torch, a: list, b: list) -> float:
    """|a - b| over every leaf at once, in f32."""
    return math.sqrt(sum(float((x.float() - y.float()).square().sum())
                         for x, y in zip(a, b)))


def compute_probs_phase(torch, K, cfg, dev, params) -> dict:
    """``compute_probs``: qwen3-1.7b at full width and depth on the restored
    weights under ``attn_probs_dtype="compute"``.  The prefill at
    PREFILL_SHAPE through the kernels (every attention the compute variant
    of flash_attention, launches exact), held against the plain compute
    path by ``hold_kernel_path`` (the prefill's limits); one train step's
    loss and gradients (``lm_loss`` under the config's ``remat="full"``:
    each attention launches twice) at TRAIN_SHAPE, the loss within
    COMPUTE_LOSS_RTOL of the plain compute path's and the gradient's
    distance from the f32 gradient (whole vector) within twice the plain
    path's.  Printed, not held: the logits' distance from the float32
    mode's and both modes' ms (prefill and step).  Returns the launches of
    the timed prefills and the kernel step."""
    from repro_torch.models.common import tree_map
    from repro_torch.serve.step import make_prefill_step

    t_phase = time.perf_counter()
    ccfg = cfg.replace(attn_probs_dtype="compute")
    B, S = PREFILL_SHAPE
    L = cfg.n_layers
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, S), device=dev,
        generator=torch.Generator(device=dev).manual_seed(COMPUTE_SEED))}
    step = make_prefill_step(ccfg)
    with torch.inference_mode():
        step(params, batch)                                   # warm-up
        reset_counts(K)
        secs, lk = timed_prefill(torch, step, params, batch, 2)
        launches = counts(K)
        want = {"flash_attention_compute": 2 * L, "flash_attention": 0,
                "rmsnorm": 2 * (4 * L + 1), "decode_attention": 0,
                "ssm_scan": 0}
        for name, n in want.items():
            check(launches[name] == n, f"compute_probs prefill {name}: "
                  f"{launches[name]} launches, expected {n}")
        (plain_s,), lp = timed_prefill(
            torch, make_prefill_step(ccfg, plain=True), params, batch, 1)
        f32_mode = make_prefill_step(cfg)
        f32_mode(params, batch)
        f32_secs, lf = timed_prefill(torch, f32_mode, params, batch, 2)
        cfg32, p32 = f32_model(ccfg, params)
        k32 = make_prefill_step(cfg32)(p32, batch)
        l32 = make_prefill_step(cfg32, plain=True)(p32, batch)
        del p32
    torch.cuda.empty_cache()
    hold = hold_kernel_path(torch, lk, lp, k32, l32,
                            "qwen3-1.7b compute prefill")
    modes = {"max_abs": (lk - lf).abs().max().item(),
             "angle": _angle(torch, lk.float(), lf.float()),
             "argmax_agree": (lk.argmax(-1) == lf.argmax(-1)).float()
             .mean().item()}
    del lk, lp, lf, k32, l32
    prefill_ms = sorted(secs)[0] * 1e3
    emit("compute_probs_prefill", arch=cfg.name, batch=B, seq=S,
         ms_per_prefill=prefill_ms, ms_all=[t * 1e3 for t in secs],
         float32_mode_ms=sorted(f32_secs)[0] * 1e3, plain_ms=plain_s * 1e3,
         launches=launches, plain_vs_kernel=hold,
         logits_vs_float32_mode=modes)

    # one train step: lm_loss and its gradients (remat "full")
    B, S = TRAIN_SHAPE
    tb = {"tokens": batch["tokens"][:B, :S]}
    reset_counts(K)
    loss_k, gk = lm_grads(torch, ccfg, params, tb, plain=False)
    step_launches = counts(K)
    # timed again: the first call of a checkpointed backward loads
    # torch's checkpoint machinery (seconds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm_grads(torch, ccfg, params, tb, plain=False)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    twice = 2 if cfg.remat == "full" else 1
    want = {"flash_attention_compute": twice * L, "flash_attention": 0,
            "rmsnorm": twice * 4 * L + 1}
    for name, n in want.items():
        check(step_launches[name] == n, f"compute_probs step {name}: "
              f"{step_launches[name]} launches, expected {n}")
    t0 = time.perf_counter()
    loss_f, gf = lm_grads(torch, cfg, params, tb, plain=False)
    torch.cuda.synchronize()
    f32_mode_step_ms = (time.perf_counter() - t0) * 1e3
    del gf
    loss_p, gp = lm_grads(torch, ccfg, params, tb, plain=True)
    cfg32 = ccfg.replace(dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    loss_32, g32 = lm_grads(torch, cfg32, p32, tb, plain=True)
    del p32
    dist_k, dist_p = _vector_dist(torch, gk, g32), _vector_dist(torch, gp,
                                                                 g32)
    finite = all(bool(torch.isfinite(g.float()).all()) for g in gk)
    del gk, gp, g32
    torch.cuda.empty_cache()
    check(finite, "compute_probs step: non-finite kernel-path gradients")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    check(rel <= COMPUTE_LOSS_RTOL, f"compute_probs step: loss {loss_k} "
          f"against the plain path's {loss_p} (rel {rel})")
    check(dist_k <= 2 * dist_p, f"compute_probs step: gradient {dist_k} "
          f"from f32, over twice the plain path's {dist_p}")
    emit("compute_probs_step", arch=cfg.name, batch=B, seq=S,
         remat=cfg.remat, loss={"bf16_kernel": loss_k, "bf16_plain": loss_p,
                                "f32_plain": loss_32,
                                "float32_mode_kernel": loss_f},
         loss_rel_diff=rel, loss_rtol=COMPUTE_LOSS_RTOL,
         grad_dist_from_f32={"kernel": dist_k, "plain": dist_p,
                             "limit": "kernel <= 2 x plain"},
         step_ms=step_ms, float32_mode_step_ms=f32_mode_step_ms,
         step_ms_note="one lm_loss forward and backward (its second "
                      "call), host clock ended by a synchronize",
         launches=step_launches,
         phase_s=time.perf_counter() - t_phase)
    return {k: launches[k] + step_launches[k] for k in launches}


def _first_batch(cfg, steps: int, B: int, S: int):
    """The tokens ``run_training(cfg, steps, B, S)`` trains on at step 0
    (its synthetic stream, seed 0, cut by ``TokenDatasetSpec``), as int32
    ``[B, S]``."""
    import numpy as np

    from repro_torch.data import TokenDatasetSpec, synthetic_tokens

    tokens = synthetic_tokens(max(B * (S + 1) * (steps + 4), 65_536),
                              cfg.vocab_size, seed=0)
    spec = TokenDatasetSpec(n_tokens=tokens.size, seq_len=S, global_batch=B)
    item = tokens.itemsize
    rows = [tokens[start // item:start // item + S + 1]
            for start, _ in spec.ranges_for_step(0)]
    return np.stack(rows)[:, :-1].astype(np.int32)


def examples_phase(torch, K, dev) -> dict:
    """``examples``: the four entry points of ``repro_torch.examples`` on
    the card, in this process.  ``quickstart`` (host: the simulator and
    three loopback mirrors); ``multisource_restore`` onto the card,
    bit-exact with the slowest mirror stopped 0.2 s in;
    ``autotune_chunks`` on the card and on the CPU, the same winners and
    their times within rtol 1e-5 (as ``geometry_card_vs_cpu``);
    ``train_100m`` for EXAMPLE_TRAIN_STEPS steps (its own assert: the loss
    trends down), its first loss equal to the kernel path's on its step-0
    weights and batch, and within COMPUTE_LOSS_RTOL of the plain path's.
    Returns train_100m's launches."""
    from repro_torch.examples import (autotune_chunks, multisource_restore,
                                      quickstart, train_100m)
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import lm_loss, model_specs

    secs = {}
    t0 = time.perf_counter()
    q = quickstart.main()
    secs["quickstart"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    r = multisource_restore.main(["--device", "cuda"])
    secs["multisource_restore"] = time.perf_counter() - t0
    check(r["bit_exact"] and r["device"].startswith("cuda"),
          f"examples: multisource_restore {r}")

    t0 = time.perf_counter()
    card = autotune_chunks.main(["--device", "cuda"])
    secs["autotune_chunks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = autotune_chunks.main(["--device", "cpu"])
    secs["autotune_chunks_cpu"] = time.perf_counter() - t0
    pairs = ([(card["grid"][k], cpu["grid"][k]) for k in card["grid"]]
             + list(zip(card["batch"], cpu["batch"])))
    worst = max(abs(a[2] - b[2]) / abs(b[2]) for a, b in pairs)
    check(all(a[:2] == b[:2] for a, b in pairs) and worst <= 1e-5,
          f"examples: autotune winners on the card {pairs} differ from the "
          f"CPU's (rel {worst})")

    cfg = train_100m.config_100m()
    B, S = 8, 256                       # the example's defaults
    tmp = tempfile.mkdtemp(prefix="chip_smoke_100m_")
    reset_counts(K)
    try:
        t0 = time.perf_counter()
        tr = train_100m.main(["--steps", str(EXAMPLE_TRAIN_STEPS),
                              "--device", "cuda", "--ckpt-dir", tmp])
        torch.cuda.synchronize()
        secs["train_100m"] = time.perf_counter() - t0
    except AssertionError as e:     # the example's own loss-trend assert
        raise CheckFailed(f"examples: train_100m: {e}") from e
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = counts(K)
    check(launches["flash_attention"] == EXAMPLE_TRAIN_STEPS * cfg.n_layers,
          f"examples: train_100m flash_attention launches {launches}")
    params = init_params(model_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         cfg.torch_dtype, dev)
    batch = {"tokens": torch.from_numpy(
        _first_batch(cfg, EXAMPLE_TRAIN_STEPS, B, S)).to(dev)}
    with torch.no_grad():
        lk = lm_loss(params, cfg, batch).item()
        lp = lm_loss(params, cfg, batch, plain=True).item()
    del params
    first = tr["losses"][0]
    check(abs(first - lk) <= 1e-3 * abs(lk), f"examples: train_100m's "
          f"first loss {first} is not its step-0 kernel loss {lk}")
    check(abs(lk - lp) <= COMPUTE_LOSS_RTOL * abs(lp), f"examples: "
          f"train_100m first loss {lk} against the plain path's {lp}")
    emit("examples", seconds=secs, quickstart=q, restore=r,
         autotune={"card": card, "cpu": cpu, "max_rel_time_diff": worst},
         train_100m={"params": tr["params"], "losses": tr["losses"],
                     "first_loss_kernel": lk, "first_loss_plain": lp,
                     "launches": launches})
    torch.cuda.empty_cache()
    return launches


def _train_like(cfg, opt) -> dict:
    """The key structure of a train state of ``cfg`` (specs as leaves)."""
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim.adamw import opt_state_specs

    from repro_torch.models.common import ParamSpec

    specs = model_specs(cfg)
    return {"params": specs, "opt": opt_state_specs(specs, opt),
            "step": ParamSpec((), (), "zeros")}


# ------------------------------------------------------------ distributed

#: olmoe-1b-7b trained at full width with its 16 layers cut to 8: 3.56 B
#: parameters, ~43 GB of bf16 weights and gradients and f32 moments
DIST_OLMOE_LAYERS = 8
DIST_SHAPE = (4, 2048)
DIST_STEPS = 3
#: the hold of the a2a path against the one-hot path where nothing drops:
#: capacity factor 64 makes the a2a path's second buffer T k cf^2 / E rows
#: per expert, so it runs at 2 layers and B 2 x S 16 (4.3 GB of buffer)
DIST_HOLD_LAYERS = 2
DIST_HOLD_SHAPE = (2, 16)
DIST_HOLD_CF = 64.0
#: the hold is bit-equality of the first loss and every router gradient:
#: at M = 1 and capacity factor 64 the two paths compute one function, and
#: five runs on the H100 read them bit-equal (PERF.md), so any difference
#: is a bucketing or gradient fault of the a2a path


class dist_group:
    """A 1-rank process group in this process (NCCL on the card, a
    ``file://`` rendezvous in a scratch directory) and a (1, 1) (data,
    model) mesh over it (``launch.mesh.make_local_mesh``); the group is
    destroyed on exit."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev

    def __enter__(self):
        import datetime

        import torch.distributed as dist

        from repro_torch.launch.mesh import make_local_mesh

        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
        dist.init_process_group(
            "nccl" if self.dev.type == "cuda" else "gloo",
            init_method=f"file://{self.tmp}/rendezvous", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300))
        return make_local_mesh(1, 1, device=self.dev)

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        shutil.rmtree(self.tmp, ignore_errors=True)


def restore_dtensor_phase(torch, cfg, dev, root, d, want):
    """``restore_dtensor`` (the distributed phase's part a, run while the
    restore phase's checkpoint is on disk): the qwen3-1.7b checkpoint
    restored over the three throttled mirrors with
    ``shardings=sharding_tree(model_specs)`` under a 1-rank NCCL (1, 1)
    mesh; every leaf a ``DTensor`` on the card whose local shard is
    bit-exact to the saved leaf."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.distributed import activate
    from repro_torch.models.common import sharding_tree, tree_leaves
    from repro_torch.models.transformer import model_specs

    with dist_group(torch, dev) as mesh, activate(mesh):
        specs = model_specs(cfg)
        shardings = sharding_tree(specs)
        with MirrorFleet(d) as fleet:
            tree, step = restore_checkpoint(root, specs, step=1,
                                            replicas=fleet.replicas,
                                            device=dev, shardings=shardings)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - fleet.t0
        got = dict(tree_leaves(tree))
        check(step == 1 and sorted(got) == sorted(want),
              "restore_dtensor: keys differ from saved")
        placements = set()
        for key, t in want.items():
            r = got[key]
            check(isinstance(r, DTensor), f"restore_dtensor: {key} is "
                  f"{type(r).__name__}, not a DTensor")
            local = r.to_local()
            placements.add(str(tuple(r.placements)))
            check(local.device == t.device and local.dtype == t.dtype
                  and local.shape == t.shape and torch.equal(local, t),
                  f"restore_dtensor: {key}'s local shard is not bit-exact")
        del tree, got
    total = os.path.getsize(os.path.join(d, "data.bin"))
    emit("restore_dtensor", arch=cfg.name, mesh=[1, 1], backend="nccl",
         restore_s=seconds, gb_per_s=total / seconds / 1e9,
         leaves=len(want), placements=sorted(placements), bit_exact=True)
    torch.cuda.empty_cache()


def _dist_train_run(torch, cfg, dev, seed, batches, mesh, opt):
    """Fresh parameters from ``seed``, ``len(batches)`` train steps (under
    ``activate(mesh)`` when a mesh is given); the losses and final
    parameters."""
    from repro_torch.distributed import activate
    from repro_torch.models.common import init_params, tree_leaves
    from repro_torch.models.transformer import model_specs
    from repro_torch.train.step import init_train_state, make_train_step

    state = init_train_state(init_params(
        model_specs(cfg), torch.Generator(device=dev).manual_seed(seed),
        cfg.torch_dtype, dev), opt)
    step = make_train_step(cfg, opt)
    losses = []
    with activate(mesh) if mesh is not None else nullcontext():
        for b in batches:
            state, m = step(state, b)
            losses.append(m["loss"].item())
    return losses, {k: t.detach() for k, t in tree_leaves(state["params"])}


def dist_qwen3_phase(torch, K, dev, mesh) -> dict:
    """``dist_qwen3_dp`` (part b): qwen3-1.7b at full width with 2 layers,
    2 AdamW steps of B 2 x S 1024 under the (1, 1) mesh, then the same from
    the same seed without one: losses and parameters bit-equal (an average
    over one rank is the identity), deterministic algorithms on."""
    from repro_torch.configs import get_config
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_config("qwen3-1.7b").replace(n_layers=GRAD_MODEL_LAYERS)
    B, S = RESUME_SHAPE
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, decay_steps=4)
    gen = torch.Generator(device=dev).manual_seed(61)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                        device=dev, generator=gen)}
               for _ in range(2)]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        reset_counts(K)
        t0 = time.perf_counter()
        lm, pm = _dist_train_run(torch, cfg, dev, 62, batches, mesh, opt)
        meshed_s = time.perf_counter() - t0
        launches = counts(K)
        lp, pp = _dist_train_run(torch, cfg, dev, 62, batches, None, opt)
    finally:
        torch.use_deterministic_algorithms(was)
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "rmsnorm": 2 * 4 * cfg.n_layers + 1}
    for name, n in per_step.items():
        check(launches[name] == 2 * n, f"dist_qwen3_dp {name}: "
              f"{launches[name]} launches, expected {n} x 2")
    check(lm == lp, f"dist_qwen3_dp: meshed losses {lm} != unmeshed {lp}")
    same = [k for k in pm if torch.equal(pm[k], pp[k])]
    check(len(same) == len(pm), f"dist_qwen3_dp: parameters differ: "
          f"{sorted(set(pm) - set(same))[:5]}")
    emit("dist_qwen3_dp", arch=cfg.name, n_layers=cfg.n_layers, batch=B,
         seq=S, mesh=[1, 1], backend="nccl", losses=lm, unmeshed_losses=lp,
         losses_bit_equal=True, params_bit_equal=len(same), meshed_s=meshed_s,
         deterministic_algorithms="on (warn_only)", launches=launches)
    del pm, pp
    torch.cuda.empty_cache()
    return launches


def _router_grads(torch, cfg, params, batch, mesh):
    """(loss, the router leaves' gradients) of one ``lm_loss`` call, under
    ``activate(mesh)`` when a mesh is given."""
    from repro_torch.distributed import activate
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import lm_loss

    keys = [k for k, _ in tree_leaves(params) if k.endswith("router")]
    leaves = dict(tree_leaves(params))
    with activate(mesh) if mesh is not None else nullcontext():
        loss = lm_loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
    return loss.item(), dict(zip(keys, grads))


def dist_olmoe_phase(torch, K, dev, mesh) -> dict:
    """Part c: olmoe-1b-7b at full width on the card through both MoE
    paths.  ``dist_olmoe_hold``: at capacity factor 64 (nothing drops) and
    2 layers, B 2 x S 16, the a2a path at M = 1 (under the mesh) and the
    one-hot path give the same first loss and router gradients, bit for
    bit.  ``dist_olmoe_train``: 8 of 16 layers, B 4 x S
    2048, the config's 1.25: DIST_STEPS timed steps and one profiled step
    through each path from the same seed (ms per step, tokens/s, peak
    memory, idle share: 1 - the profiled step's device busy time / the
    unprofiled warm step's host time, as ``train`` reads it; tracing
    lengthens a saturated step's kernels, so it can read a little below
    0), every loss finite, launches per step exact, and each path's
    dropped pairs in one forward.  Returns the launches by
    path."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import activate
    from repro_torch.models import moe
    from repro_torch.models.common import init_params, tree_leaves, tree_map
    from repro_torch.models.transformer import lm_loss, model_specs
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step

    base = get_config("olmoe-1b-7b")
    by_path = {}

    # --- the hold where nothing drops
    cfg = base.replace(n_layers=DIST_HOLD_LAYERS, capacity_factor=DIST_HOLD_CF)
    params = tree_map(lambda t: t.requires_grad_(True), init_params(
        model_specs(cfg), torch.Generator(device=dev).manual_seed(71),
        cfg.torch_dtype, dev))
    B, S = DIST_HOLD_SHAPE
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, S), device=dev,
        generator=torch.Generator(device=dev).manual_seed(72))}
    probe = MoEProbe(torch, moe)
    probe.empty = cfg.n_experts
    reset_counts(K)
    (la, ga), drop_a = probe.run(lambda: _router_grads(torch, cfg, params,
                                                       batch, mesh))
    probe.empty = None
    (lo, go), drop_o = probe.run(lambda: _router_grads(torch, cfg, params,
                                                       batch, None))
    by_path["dist_olmoe_hold"] = counts(K)
    check(drop_a == 0 and drop_o == 0, f"dist_olmoe_hold: pairs dropped at "
          f"capacity factor {DIST_HOLD_CF}: a2a {drop_a}, one-hot {drop_o}")
    check(la == lo, f"dist_olmoe_hold: loss {la} (a2a) vs {lo} (one-hot)")
    grads = {}
    for k in go:
        a, o = ga[k].float(), go[k].float()
        cos = torch.nn.functional.cosine_similarity(
            a.flatten(), o.flatten(), dim=0).item()
        err = (a - o).abs().max().item()
        peak = o.abs().max().item()
        grads[k] = {"max_abs_err": err, "max_abs": peak, "cosine": cos}
        check(torch.equal(ga[k], go[k]),
              f"dist_olmoe_hold: {k} gradient {grads[k]}")
    emit("dist_olmoe_hold", arch=base.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
         batch=B, seq=S, capacity_factor=cfg.capacity_factor,
         loss_a2a=la, loss_one_hot=lo, router_grads=grads,
         dropped_pairs={"a2a": drop_a, "one_hot": drop_o},
         tolerance="bit-equal",
         launches=by_path["dist_olmoe_hold"])
    del params, ga, go
    torch.cuda.empty_cache()

    # --- training at full width, both paths from the same seed
    cfg = base.replace(n_layers=DIST_OLMOE_LAYERS)
    B, S = DIST_SHAPE
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, decay_steps=10_000)
    gen = torch.Generator(device=dev).manual_seed(73)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                        device=dev, generator=gen)}
               for _ in range(DIST_STEPS + 1)]
    L = cfg.n_layers
    per_step = {"flash_attention": 2 * L, "rmsnorm": 2 * 4 * L + 1}
    per_forward = {"flash_attention": L, "rmsnorm": 4 * L + 1}
    for path, m in (("a2a", mesh), ("one_hot", None)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(model_specs(cfg), torch.Generator(
            device=dev).manual_seed(74), cfg.torch_dtype, dev)
        n_params = sum(t.numel() for _, t in tree_leaves(params))
        state = init_train_state(params, opt)
        step = make_train_step(cfg, opt)
        reset_counts(K)
        losses, secs = [], []
        with activate(m) if m is not None else nullcontext():
            for b in batches[:DIST_STEPS]:
                t0 = time.perf_counter()
                state, met = step(state, b)
                losses.append(met["loss"].item())
                secs.append(time.perf_counter() - t0)
            holder = {}

            def one_step():
                holder["s"], _ = step(state, batches[DIST_STEPS])

            t0 = time.perf_counter()
            prof = train_profile(torch, one_step)
            profiled_ms = (time.perf_counter() - t0) * 1e3
            state = holder.pop("s")
            peak = torch.cuda.max_memory_allocated()
            probe.empty = cfg.n_experts if m is not None else None
            with torch.no_grad():
                _, dropped = probe.run(lambda: lm_loss(
                    state["params"], cfg, batches[0]))
            probe.empty = None
        launches = counts(K)
        for name, n in per_step.items():
            want = n * (DIST_STEPS + 1) + per_forward[name]
            check(launches[name] == want, f"dist_olmoe_train {path} {name}: "
                  f"{launches[name]} launches, expected {want}")
        check(all(math.isfinite(x) for x in losses),
              f"dist_olmoe_train {path}: losses {losses}")
        warm = sorted(secs[1:])
        ms = warm[len(warm) // 2] * 1e3
        by_path[f"dist_olmoe_{path}"] = launches
        emit("dist_olmoe_train", path=path, arch=base.name, n_layers=L,
             n_layers_config=base.n_layers, d_model=cfg.d_model,
             n_experts=cfg.n_experts, top_k=cfg.top_k, d_ff=cfg.d_ff,
             vocab=cfg.vocab_size, params=n_params, batch=B, seq=S,
             capacity_factor=cfg.capacity_factor, remat=cfg.remat,
             mesh=[1, 1] if m is not None else None, losses=losses,
             step_s=secs, ms_per_step_warm=ms,
             tokens_per_s=B * S / (ms / 1e3), max_memory_allocated=peak,
             device_busy_ms=prof["device_busy_ms"],
             profiled_step_ms=profiled_ms,
             device_idle_share=1.0 - prof["device_busy_ms"] / ms,
             top_kernels=prof["top_kernels"][:5],
             dropped_pairs_one_forward=dropped,
             pairs_one_forward=B * S * cfg.top_k * L, launches=launches)
        del state, params, holder
        torch.cuda.empty_cache()
    return by_path


def dist_compression_phase(torch, K, dev, mesh) -> dict:
    """Part d: ``compressed_mean`` of the gradient tree of qwen3-1.7b at
    full width with 2 layers (B 2 x S 1024), and
    ``compressed_reduce_scatter`` of each leaf, over the 1-rank group: q
    and scale of every leaf bit-equal to ``quantize_int8`` of the same
    gradient on the CPU, and both outputs bit-equal to the same arithmetic
    on the CPU (the sum over one rank)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import Mesh
    from repro_torch.models.common import init_params, tree_leaves, tree_map
    from repro_torch.models.transformer import lm_loss, model_specs
    from repro_torch.optim.compression import (compressed_mean,
                                               compressed_reduce_scatter,
                                               quantize_int8)
    from repro_torch.weights import unflatten

    cfg = get_config("qwen3-1.7b").replace(n_layers=GRAD_MODEL_LAYERS)
    B, S = RESUME_SHAPE
    params = tree_map(lambda t: t.requires_grad_(True), init_params(
        model_specs(cfg), torch.Generator(device=dev).manual_seed(81),
        cfg.torch_dtype, dev))
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, S), device=dev,
        generator=torch.Generator(device=dev).manual_seed(82))}
    reset_counts(K)
    keys, leaves = zip(*tree_leaves(params))
    grads = unflatten(dict(zip(keys, torch.autograd.grad(
        lm_loss(params, cfg, batch), leaves))))
    launches = counts(K)
    group = Mesh.of(mesh).group(("data",))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    means = compressed_mean(grads, group)
    torch.cuda.synchronize()
    mean_ms = (time.perf_counter() - t0) * 1e3
    n = 0
    rs_ms = 0.0
    for key, g in tree_leaves(grads):
        q, s = quantize_int8(g)
        qc, sc = quantize_int8(g.cpu())
        check(torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc),
              f"dist_compression: {key}'s q / scale differ from the CPU's")
        want = (qc.to(torch.bfloat16) * sc.to(torch.bfloat16) / 1).float()
        check(torch.equal(dict(tree_leaves(means))[key].cpu(), want),
              f"dist_compression: compressed_mean of {key}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs = compressed_reduce_scatter(g, group)
        torch.cuda.synchronize()
        rs_ms += (time.perf_counter() - t0) * 1e3
        want = (qc.reshape(1, -1).float() * sc.reshape(1, 1)).sum(dim=0) / 1
        check(torch.equal(rs.cpu(), want),
              f"dist_compression: compressed_reduce_scatter of {key}")
        n += g.numel()
    emit("dist_compression", arch=cfg.name, n_layers=cfg.n_layers,
         leaves=len(keys), elements=n, group_size=1, backend="nccl",
         q_scale_bit_equal_to_cpu=True, outputs_bit_equal_to_cpu=True,
         compressed_mean_ms=mean_ms, compressed_reduce_scatter_ms=rs_ms,
         launches=launches)
    del params, grads, means
    torch.cuda.empty_cache()
    return launches

#: the two gloo ranks on one card: olmoe's MoE block at full width (d 2048,
#: E 64, top 8, d_ff 1024) in f32 on a (1, 2) mesh, each rank holding 32
#: experts, at capacity factor 64 (nothing drops, so M = 2 and M = 1 route
#: the same pairs); outputs and gradients within GLOO_TOL of the 1-rank
#: run's
GLOO_SHAPE = (1, 16)
GLOO_TOL = 1e-5


def _gloo_moe_case(torch, dev):
    """The MoE block's config, parameters, input and cotangent, drawn on
    the CPU from a seed (every process draws the same) and moved to
    ``dev``."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import init_params
    from repro_torch.models.moe import moe_specs

    cfg = get_config("olmoe-1b-7b").replace(dtype="float32",
                                             capacity_factor=DIST_HOLD_CF)
    g = torch.Generator().manual_seed(91)
    p = init_params(moe_specs(cfg), g, torch.float32, torch.device("cpu"))
    x = torch.randn((*GLOO_SHAPE, cfg.d_model), generator=g)
    cot = torch.randn(x.shape, generator=g)
    return cfg, {k: v.to(dev) for k, v in p.items()}, x.to(dev), cot.to(dev)


def _gloo_moe_grads(torch, cfg, p, x, cot):
    """y and the gradients of mean(y . cot) + lb for x and each leaf."""
    from repro_torch.models.moe import moe_block

    p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    x = x.detach().requires_grad_(True)
    y, lb = moe_block(p, cfg, x)
    keys = sorted(p)
    g = torch.autograd.grad((y * cot).sum(-1).mean() + lb,
                            [x] + [p[k] for k in keys])
    return y.detach(), lb.item(), dict(zip(["x"] + keys, g))


def moe_rank(torch, K, dev, rank: int, out: str) -> dict:
    """``--gloo-program moe``: one of two gloo ranks on the card (a (1, 2)
    mesh), the MoE block through the a2a path."""
    from repro_torch.distributed import activate
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.moe import moe_specs

    cfg, p, x, cot = _gloo_moe_case(torch, dev)
    with activate(make_local_mesh(1, 2, device=dev)) as ctx:
        specs = moe_specs(cfg)
        blocks = {k: ctx.mesh.local_slices(ctx.spec(s.logical, s.shape),
                                           s.shape)
                  for k, s in specs.items()}
        local = {k: p[k][blocks[k]].contiguous() for k in p}
        blocks = {k: [(sl.start, sl.stop) for sl in v]
                  for k, v in blocks.items()}
        y, lb, g = _gloo_moe_grads(torch, cfg, local, x, cot)
    return {"y": y.cpu(), "lb": lb, "blocks": blocks,
            "grads": {k: v.cpu() for k, v in g.items()},
            "device": str(y.device)}


def gloo_rank(torch, K, rank: int, out: str, program: str) -> int:
    """``--gloo-rank R --gloo-dir D --gloo-program P``: rank R of the gloo
    program P (``GLOO_PROGRAMS``: its world size and function) on the
    card; writes its result to ``D/rankR.pt``."""
    import datetime

    import torch.distributed as dist

    world, fn = GLOO_PROGRAMS[program]
    dist.init_process_group(
        # a file of its own per program: a later spawn into the same
        # directory must not read the addresses an earlier one left there
        "gloo", init_method=f"file://{out}/rendezvous_{program}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        res = fn(torch, K, torch.device("cuda", 0), rank, out)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def dist_gloo_phase(torch, dev, mesh) -> None:
    """``dist_gloo_two_ranks``: two gloo ranks spawned on the one card hold
    32 experts each of olmoe's MoE block at full width and exchange their
    buckets by all-to-all (gloo takes CUDA tensors for every collective the
    path uses); at capacity factor 64 their outputs and gradients match
    this process's 1-rank NCCL run of the same block within GLOO_TOL of
    each tensor's largest entry.  No kernel runs in the MoE block."""
    from repro_torch.distributed import activate

    out = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    try:
        # this process's run first, its results moved off the card, so the
        # two ranks find the card's memory free
        cfg, p, x, cot = _gloo_moe_case(torch, dev)
        with activate(mesh):
            y1, lb1, g1 = _gloo_moe_grads(torch, cfg, p, x, cot)
        y1, g1 = y1.cpu(), {k: v.cpu() for k, v in g1.items()}
        del p, x, cot
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = _spawn_ranks(torch, "moe", 2, out)
        seconds = time.perf_counter() - t0
        worst = {}
        for r, res in enumerate(ranks):
            check(res["device"].startswith("cuda"),
                  f"dist_gloo_two_ranks: rank {r} ran on {res['device']}")
            pairs = [("y", res["y"], y1)] + [
                (k, v, g1[k][tuple(slice(*ab) for ab in
                                   res["blocks"].get(k, ()))])
                for k, v in res["grads"].items()]
            for name, got, want in pairs:
                err = (got - want).abs().max().item()
                peak = want.abs().max().item()
                worst[name] = max(worst.get(name, 0.0), err / max(peak, 1e-30))
                check(got.shape == want.shape and err <= GLOO_TOL * peak,
                      f"dist_gloo_two_ranks: rank {r} {name} off by {err} "
                      f"(largest entry {peak})")
            check(abs(res["lb"] - lb1) <= 1e-6,
                  f"dist_gloo_two_ranks: rank {r} lb {res['lb']} vs {lb1}")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    emit("dist_gloo_two_ranks", arch=cfg.name, d_model=cfg.d_model,
         n_experts=cfg.n_experts, top_k=cfg.top_k, batch=GLOO_SHAPE[0],
         seq=GLOO_SHAPE[1], dtype="float32", mesh=[1, 2], backend="gloo",
         capacity_factor=cfg.capacity_factor, tolerance_rel=GLOO_TOL,
         max_rel_err=worst, seconds=seconds)



# ----------------------------------------------------- tensor parallelism

#: dist_tp_qwen3: qwen3-1.7b at full width (TP_LAYERS layers) on two gloo
#: ranks of a (1, 2) mesh under rules_for(qwen3) (DEFAULT_RULES for this
#: arch), B 2 x S 2048 at bf16 with the config's remat="full", TP_STEPS
#: steps; held
#: against this process's 1-rank NCCL run of the same batches: each loss
#: within TP_LOSS_RTOL relative, step 0's gradient of every leaf at
#: cosine > TP_COS on each rank's block; then at f32 with TP_F32_LAYERS
#: layers and B 2 x S 512: losses, clip norms and step 0's gradients within
#: TP_F32_TOL relative of each tensor's largest entry
TP_SHAPE = (2, 2048)
#: dist_tp_qwen3's bf16 depth: 28 -> 8 layers (the time limit, once the
#: encdec and vlm phases joined the script), 8 -> 2 once the multi-pod
#: phase did
TP_LAYERS = 2
#: steps a TP run takes (3 until the encdec and vlm phases joined the
#: script: the time limit)
TP_STEPS = 2
TP_LOSS_RTOL = 2e-3
TP_COS = 0.999
TP_F32_LAYERS = 2
TP_F32_SHAPE = (2, 512)
TP_F32_TOL = 1e-4
#: dist_zero1_save: four gloo ranks of a (2, 2) mesh under rules_for +
#: opt_rules_for, qwen3-1.7b at full width with its 28 layers cut to
#: ZERO1_LAYERS (four ranks share the card and the time budget; 8 until
#: decode under a mesh joined the script, 4 until the multi-pod phase
#: did), global batch B 4 x S 2048, TP_STEPS steps with ZeRO-1 moments
#: and without
ZERO1_LAYERS = 2
ZERO1_SHAPE = (4, 2048)


def _tp_batches(torch, cfg, dev, shape, seed: int) -> list:
    """TP_STEPS batches ``{"tokens": [B, S]}`` of the global shape, drawn
    on ``dev`` from ``seed`` (every process draws the same); for the
    encdec and vlm families also their frames or patches (``[B,
    CROSS_MEMORY, frontend_dim]``, ``stub_inputs`` from ``seed + 1000 +
    i``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = [{"tokens": torch.randint(0, cfg.vocab_size, shape, device=dev,
                                    generator=gen)}
           for _ in range(TP_STEPS)]
    if cfg.family in ("encdec", "vlm"):
        for i, b in enumerate(out):
            b.update(stub_inputs(torch, cfg, shape[0], CROSS_MEMORY[
                cfg.family], dev, seed + 1000 + i))
    return out


def _draw_full(torch, cfg, dev, seed: int) -> dict:
    """``cfg``'s whole parameters drawn on ``dev`` from ``seed`` by
    ``init_params``, as every process draws them; for the encdec and vlm
    families the zero-init leaves set nonzero (``set_nonzero_inits``: the
    vlm gates would make every cross-attention add nothing)."""
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import model_specs

    full = init_params(model_specs(cfg), torch.Generator(
        device=dev).manual_seed(seed), cfg.torch_dtype, dev)
    if cfg.family in ("encdec", "vlm"):
        set_nonzero_inits(torch, cfg, full, seed)
    return full


def _sharded_train(torch, K, cfg, dev, mesh, opt, seed: int, batches: list,
                   multi_pod: bool = False, routing=None):
    """Parameters drawn whole on ``dev`` from ``seed`` (``_draw_full``, as
    every process draws them), this rank's blocks cut under
    ``rules_for(cfg, multi_pod)``'s storage rules,
    ``init_sharded_train_state`` and one train step per batch (this
    rank's rows of each of its tensors).  Returns the state, the leaves'
    slices, and a record: losses, clip norms, ms per step, peak device
    bytes, the kernels' launches and step 0's reduced gradients (on the
    host); with ``multi_pod`` also ``blocks_ok``: every parameter block is
    the whole draw's block ``_data_major`` names (bytes), every moment has
    the shape of its block under ``opt_rules_for`` (``_data_major`` too),
    and ``moment_bytes_want``, the bytes those blocks take.  ``routing``
    (a pinned ``MoEProbe``, ``_pinned``) is entered around the steps."""
    import repro_torch.train.step as train_step
    from repro_torch.distributed import activate
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import model_specs
    from repro_torch.weights import unflatten

    _, storage = rules_for(cfg, multi_pod)
    full = _draw_full(torch, cfg, dev, seed)
    blocks = {}
    with nullcontext() if mesh is None else activate(mesh, storage) as ctx:
        specs = dict(tree_leaves(model_specs(cfg)))
        slices = {k: tuple(slice(0, n) for n in s.shape) if ctx is None
                  else ctx.mesh.local_slices(ctx.spec(s.logical, s.shape),
                                             s.shape)
                  for k, s in specs.items()}
        local = unflatten({k: t[slices[k]].clone()
                           for k, t in tree_leaves(full)})
        if multi_pod:
            octx = train_step._opt_ctx(ctx)
            for k, s in specs.items():
                blocks[k] = (_data_major(ctx, s.logical, s.shape),
                             _data_major(octx, s.logical, s.shape))
            blocks_ok = all(torch.equal(t, full_t[blocks[k][0]])
                            for (k, t), (_, full_t) in zip(
                                tree_leaves(local), tree_leaves(full)))
        del full
        torch.cuda.empty_cache()
        state = (train_step.init_train_state(local, opt) if ctx is None
                 else train_step.init_sharded_train_state(local, cfg, opt))
        if multi_pod:
            mdt = getattr(torch, opt.moment_dtype).itemsize
            want = {k: tuple(sl.stop - sl.start for sl in blocks[k][1])
                    for k in specs}
            blocks_ok = blocks_ok and all(
                tuple(m.shape) == want[k] for part in ("m", "v")
                for k, m in tree_leaves(state["opt"][part]))
        step = train_step.make_train_step(cfg, opt)
        bi, nb = (0, 1) if ctx is None else ctx.batch_shard()
        real, seen = train_step.adamw_apply, []

        def recording(grads, *a, **kw):
            if not seen:
                seen.append({k: g.detach().cpu()
                             for k, g in tree_leaves(grads)})
            return real(grads, *a, **kw)

        rec = {"losses": [], "grad_norms": [], "ms": []}
        torch.cuda.reset_peak_memory_stats()
        reset_counts(K)
        train_step.adamw_apply = recording
        try:
            with nullcontext() if routing is None else routing:
                for b in batches:
                    n = b["tokens"].shape[0] // nb
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, m = step(state, {k: v[bi * n:(bi + 1) * n]
                                            for k, v in b.items()})
                    rec["losses"].append(m["loss"].item())
                    rec["grad_norms"].append(m["grad_norm"].item())
                    torch.cuda.synchronize()
                    rec["ms"].append((time.perf_counter() - t0) * 1e3)
        finally:
            train_step.adamw_apply = real
        rec["launches"] = counts(K)
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rec["moment_bytes"] = sum(
            t.numel() * t.element_size()
            for k in ("m", "v") for _, t in tree_leaves(state["opt"][k]))
        rec["grads0"] = seen[0]
        rec["device"] = str(tree_leaves(state["params"])[0][1].device)
        if multi_pod:
            rec["blocks_ok"] = blocks_ok
            rec["moment_bytes_want"] = 2 * mdt * sum(
                math.prod(n) for n in want.values())
    return state, slices, rec


def _data_major(ctx, logical, shape) -> tuple:
    """The block of a leaf the rank at this coordinate holds under
    ``ctx``'s rules, by hand: along each dim's entry the first named axis
    is major (JAX's order; ``("data", "pod")`` under the multi-pod rules
    is data-major), one ``slice`` per dim."""
    coord = ctx.mesh.coordinate()
    spec = ctx.spec(logical, shape)
    out = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        idx, parts = 0, 1
        for a in axes:
            idx, parts = (idx * ctx.mesh.shape[a] + coord[a],
                          parts * ctx.mesh.shape[a])
        out.append(slice(idx * n // parts, (idx + 1) * n // parts))
    return tuple(out)


def _per_step_launches(cfg) -> dict:
    """Each kernel's launches a train step of a dense config with
    remat="full": forward and recompute of every layer's attention and
    its four norms (ln1, ln2, q_norm, k_norm), plus the final norm."""
    return {"flash_attention": 2 * cfg.n_layers,
            "rmsnorm": 2 * 4 * cfg.n_layers + 1}


def _tp_configs():
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-1.7b")
    return (cfg.replace(n_layers=TP_LAYERS),
            cfg.replace(n_layers=TP_F32_LAYERS, dtype="float32"))


def _tp_opt(steps: int, zero1: bool = True):
    from repro_torch.optim.adamw import AdamWConfig

    return AdamWConfig(lr=3e-4, warmup_steps=1, decay_steps=steps,
                       zero1=zero1)


def tp_rank(torch, K, dev, rank: int, out: str) -> dict:
    """``--gloo-program tp``: one of two ranks of dist_tp_qwen3 (a (1, 2)
    mesh); holds its runs against the 1-rank run's saved results."""
    from repro_torch.launch.mesh import make_local_mesh

    cfg, cfg32 = _tp_configs()
    mesh = make_local_mesh(1, 2, device=dev)
    ref = torch.load(os.path.join(out, "ref.pt"), mmap=True)
    res = {}
    for tag, c, shape, seed in (("bf16", cfg, TP_SHAPE, 101),
                                ("f32", cfg32, TP_F32_SHAPE, 103)):
        state, slices, rec = _sharded_train(
            torch, K, c, dev, mesh, _tp_opt(TP_STEPS), seed,
            _tp_batches(torch, c, dev, shape, seed + 1))
        del state
        torch.cuda.empty_cache()
        held = {}
        for k, g in rec.pop("grads0").items():
            want = ref[tag]["grads0"][k][slices[k]].float()
            g = g.float()
            if tag == "bf16":
                held[k] = float(torch.nn.functional.cosine_similarity(
                    g.reshape(-1), want.reshape(-1), dim=0))
            else:
                held[k] = float((g - want).abs().max()
                                / want.abs().max().clamp_min(1e-30))
        rec["held"] = held
        res[tag] = rec
    return res


def zero1_rank(torch, K, dev, rank: int, out: str) -> dict:
    """``--gloo-program zero1``: one of four ranks of dist_zero1_save (a
    (2, 2) mesh): the run with ZeRO-1 moments, saved through an async
    ``CheckpointManager`` with ``shardings=``, then without; this rank's
    blocks go to ``out`` for the main process to assemble."""
    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.distributed import activate
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import model_specs
    from repro_torch.train.step import train_state_shardings

    cfg = _tp_configs()[0].replace(n_layers=ZERO1_LAYERS)
    specs = dict(tree_leaves(model_specs(cfg)))
    mesh = make_local_mesh(2, 2, device=dev)
    batches = _tp_batches(torch, cfg, dev, ZERO1_SHAPE, 107)
    res = {}
    for zero1 in (True, False):
        tag = "zero1" if zero1 else "plain"
        state, slices, rec = _sharded_train(
            torch, K, cfg, dev, mesh, _tp_opt(TP_STEPS, zero1), 105,
            batches)
        rec.pop("grads0")
        blocks = {"params": {k: (slices[k], t.detach().cpu())
                             for k, t in tree_leaves(state["params"])}}
        if zero1:
            with activate(mesh, rules_for(cfg, False)[1]):
                shardings = train_state_shardings(cfg, state)
                mgr = CheckpointManager(os.path.join(out, "ckpt"),
                                        every_steps=TP_STEPS, keep=1)
                t0 = time.perf_counter()
                check(mgr.maybe_save(TP_STEPS, state, shardings=shardings),
                      "dist_zero1_save: maybe_save did not save")
                mgr.wait()
                rec["save_s"] = time.perf_counter() - t0
            rec["latest_step"] = latest_step(os.path.join(out, "ckpt"))
            flat_sh = dict(tree_leaves(shardings["opt"]))
            blocks["opt"] = {}
            for k, t in tree_leaves(state["opt"]):
                if k != "step":
                    pl = flat_sh[k]
                    blocks["opt"][k] = (pl.mesh.local_slices(
                        pl.spec, specs[k.split("/", 1)[1]].shape), t.cpu())
            blocks["steps"] = (state["opt"]["step"].cpu(),
                               state["step"].cpu())
        torch.save(blocks, os.path.join(out, f"{tag}_r{rank}.pt"))
        del state, blocks
        torch.cuda.empty_cache()
        res[tag] = rec
    return res


def _spawn_ranks(torch, program: str, world: int, out: str) -> list:
    """``world`` processes of this script, ``--gloo-program program``, one
    gloo rank each on the card (this process has freed the card's memory
    before); every rank's result, in rank order."""
    import repro_torch

    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--gloo-rank", str(r), "--gloo-dir", out,
                               "--gloo-program", program, "--src", src])
             for r in range(world)]
    try:
        rcs = [pr.wait(timeout=900) for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    check(rcs == [0] * world, f"{program} ranks exited {rcs}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _sum_launches(recs) -> dict:
    out = {}
    for rec in recs:
        for k, n in rec["launches"].items():
            out[k] = out.get(k, 0) + n
    return out


def dist_tp_phase(torch, K, dev, mesh) -> dict:
    """``dist_tp_qwen3``: qwen3-1.7b at full width (TP_LAYERS layers), tensor
    parallel over two gloo ranks spawned on the card (8 of 16 query heads,
    4 of 8 KV heads, 3,072 of 6,144 MLP columns and 75,968 of 151,936
    vocabulary rows each; the vocab-parallel loss), against this
    process's run of the same batches on the 1-rank NCCL (1, 1) mesh,
    at bf16 (B 2 x S 2048) and at f32 (2 layers, B 2 x S 512).
    The ranks' collectives are gloo's, through the host, on one card: their
    times are not NVLink's."""
    cfg, cfg32 = _tp_configs()
    out = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    one = {}
    try:
        ref = {}
        for tag, c, shape, seed in (("bf16", cfg, TP_SHAPE, 101),
                                    ("f32", cfg32, TP_F32_SHAPE, 103)):
            state, _, rec = _sharded_train(
                torch, K, c, dev, mesh, _tp_opt(TP_STEPS), seed,
                _tp_batches(torch, c, dev, shape, seed + 1))
            del state
            torch.cuda.empty_cache()
            ref[tag] = {"grads0": rec.pop("grads0")}
            one[tag] = rec
        torch.save(ref, os.path.join(out, "ref.pt"))
        del ref
        t0 = time.perf_counter()
        ranks = _spawn_ranks(torch, "tp", 2, out)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    report = {}
    for tag, c in (("bf16", cfg), ("f32", cfg32)):
        want = {k: TP_STEPS * n for k, n in _per_step_launches(c).items()}
        l1 = one[tag]["losses"]
        for r, res in enumerate(ranks):
            rec = res[tag]
            check(rec["device"].startswith("cuda"),
                  f"dist_tp_qwen3 {tag}: rank {r} ran on {rec['device']}")
            for name, n in want.items():
                check(rec["launches"][name] == n,
                      f"dist_tp_qwen3 {tag}: rank {r} launched {name} "
                      f"{rec['launches'][name]} times, expected {n}")
            rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"],
                                                         l1))
            if tag == "bf16":
                worst = min(rec["held"].items(), key=lambda kv: kv[1])
                check(rel <= TP_LOSS_RTOL and worst[1] > TP_COS,
                      f"dist_tp_qwen3 bf16: rank {r} losses {rec['losses']}"
                      f" vs {l1}, least gradient cosine {worst}")
            else:
                worst = max(rec["held"].items(), key=lambda kv: kv[1])
                gn = max(abs(a - b) / abs(b) for a, b in zip(
                    rec["grad_norms"], one[tag]["grad_norms"]))
                check(rel <= TP_F32_TOL and gn <= TP_F32_TOL
                      and worst[1] <= TP_F32_TOL,
                      f"dist_tp_qwen3 f32: rank {r} losses rel {rel}, clip "
                      f"norms rel {gn}, worst gradient {worst}")
            report.setdefault(tag, []).append({
                "losses": rec["losses"], "ms_per_step": rec["ms"],
                "peak_gb": rec["peak_gb"], "launches": rec["launches"],
                "loss_rel_err": rel, "worst_leaf": worst,
                "moment_gb": rec["moment_bytes"] / 1e9})
        report[f"{tag}_one_rank"] = {
            "losses": l1, "ms_per_step": one[tag]["ms"],
            "peak_gb": one[tag]["peak_gb"],
            "moment_gb": one[tag]["moment_bytes"] / 1e9}
    emit("dist_tp_qwen3", arch=cfg.name, n_layers=cfg.n_layers,
         batch=TP_SHAPE[0], seq=TP_SHAPE[1], steps=TP_STEPS, mesh=[1, 2],
         backend="gloo (through the host, two ranks on one card, not "
         "NVLink)", one_rank_backend="nccl (1, 1)", heads_per_rank=[
             cfg.n_heads // 2, cfg.n_kv_heads // 2],
         mlp_per_rank=cfg.d_ff // 2, vocab_per_rank=cfg.vocab_size // 2,
         f32_layers=TP_F32_LAYERS, f32_shape=list(TP_F32_SHAPE),
         loss_rtol=TP_LOSS_RTOL, cos_min=TP_COS, f32_tol=TP_F32_TOL,
         spawn_s=seconds, **report)
    return _sum_launches([res[t] for res in ranks for t in ("bf16", "f32")])


def _same_file(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(64 * MB), fb.read(64 * MB)
            if x != y:
                return False
            if not x:
                return True


def dist_zero1_phase(torch, K, dev, mesh) -> dict:
    """``dist_zero1_save``: qwen3-1.7b at full width with ZERO1_LAYERS
    layers on four gloo ranks of a (2, 2) mesh, run with ZeRO-1 moments
    (saved through ``CheckpointManager(shardings=)``) and without.  Here:
    both runs' parameters assembled from the ranks' blocks are bit-equal;
    the ZeRO-1 state assembled whole and saved by ``save_checkpoint`` has
    the sharded save's bytes; the sharded save restores bit-exact through
    ``restore_checkpoint(shardings=)`` on the (1, 1) mesh."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.distributed import activate
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import model_specs
    from repro_torch.train.step import train_state_shardings
    from repro_torch.weights import unflatten

    cfg = _tp_configs()[0].replace(n_layers=ZERO1_LAYERS)
    specs = dict(tree_leaves(model_specs(cfg)))
    out = tempfile.mkdtemp(prefix="chip_smoke_zero1_")
    disk_gb = shutil.disk_usage(out).free / 1e9
    try:
        t0 = time.perf_counter()
        ranks = _spawn_ranks(torch, "zero1", 4, out)
        seconds = time.perf_counter() - t0

        def assemble(tag: str, part: str) -> dict:
            full = {}
            for r in range(4):
                blocks = torch.load(os.path.join(out, f"{tag}_r{r}.pt"),
                                    mmap=True, weights_only=False)[part]
                for k, (sl, t) in blocks.items():
                    shape = specs[k.split("/", 1)[1] if part == "opt"
                                  else k].shape
                    full.setdefault(k, torch.empty(shape, dtype=t.dtype))
                    full[k][sl] = t
            return full

        z1, plain = assemble("zero1", "params"), assemble("plain", "params")
        differ = [k for k in z1 if not torch.equal(z1[k], plain[k])]
        del plain
        flat = {f"params/{k}": t for k, t in z1.items()}
        flat.update({f"opt/{k}": t for k, t in
                     assemble("zero1", "opt").items()})
        steps = torch.load(os.path.join(out, "zero1_r0.pt"),
                           weights_only=False)["steps"]
        flat["opt/step"], flat["step"] = steps
        state = unflatten(flat)
        for r in range(4):
            for tag in ("zero1", "plain"):
                os.remove(os.path.join(out, f"{tag}_r{r}.pt"))
        t1 = time.perf_counter()
        whole = save_checkpoint(os.path.join(out, "whole"), TP_STEPS, state)
        whole_s = time.perf_counter() - t1
        sharded = os.path.join(out, "ckpt", f"step_{TP_STEPS:010d}")
        same = {f: _same_file(os.path.join(whole, f),
                              os.path.join(sharded, f))
                for f in ("data.bin", "manifest.json")}
        nbytes = os.path.getsize(os.path.join(sharded, "data.bin"))
        shutil.rmtree(whole)
        with activate(mesh, rules_for(cfg, False)[1]):
            shardings = train_state_shardings(cfg, state)
            t1 = time.perf_counter()
            tree, step = restore_checkpoint(os.path.join(out, "ckpt"), state,
                                            device=dev, shardings=shardings)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t1
        got = dict(tree_leaves(tree))
        bad = [k for k, t in flat.items()
               if not torch.equal(got[k].to_local().cpu()
                                  if hasattr(got[k], "to_local")
                                  else got[k].cpu(), t)]
        del tree, got, state, flat
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    check(not differ, f"dist_zero1_save: ZeRO-1 parameters differ from the "
          f"plain run's: {differ[:5]}")
    check(all(same.values()), f"dist_zero1_save: the sharded save differs "
          f"from the whole save: {same}")
    check(step == TP_STEPS and not bad, f"dist_zero1_save: restore of step "
          f"{step} not bit-exact: {bad[:5]}")
    want = {k: TP_STEPS * n for k, n in _per_step_launches(cfg).items()}
    per_rank = []
    for r, res in enumerate(ranks):
        z, p = res["zero1"], res["plain"]
        check(z["latest_step"] == TP_STEPS, f"dist_zero1_save: rank {r} "
              f"sees latest step {z['latest_step']}")
        check(z["losses"] == p["losses"], f"dist_zero1_save: rank {r} "
              f"losses {z['losses']} vs {p['losses']}")
        ratio = z["moment_bytes"] / p["moment_bytes"]
        check(0.5 <= ratio < 0.51, f"dist_zero1_save: rank {r}'s moments "
              f"take {ratio} of the plain run's")
        for rec in (z, p):
            check(rec["device"].startswith("cuda"),
                  f"dist_zero1_save: rank {r} ran on {rec['device']}")
            for name, n in want.items():
                check(rec["launches"][name] == n,
                      f"dist_zero1_save: rank {r} launched {name} "
                      f"{rec['launches'][name]} times, expected {n}")
        per_rank.append({
            "zero1": {"peak_gb": z["peak_gb"], "ms_per_step": z["ms"],
                      "moment_gb": z["moment_bytes"] / 1e9,
                      "save_s": z["save_s"]},
            "plain": {"peak_gb": p["peak_gb"], "ms_per_step": p["ms"],
                      "moment_gb": p["moment_bytes"] / 1e9},
            "losses": z["losses"]})
    emit("dist_zero1_save", arch=cfg.name, n_layers=cfg.n_layers,
         batch=ZERO1_SHAPE[0], seq=ZERO1_SHAPE[1], steps=TP_STEPS,
         mesh=[2, 2], backend="gloo (through the host, four ranks on one "
         "card)", params_bit_equal=True, sharded_save_bytes=nbytes,
         byte_identical=same, restore_bit_exact=True, restore_s=restore_s,
         whole_save_s=whole_s, spawn_s=seconds, disk_free_gb=disk_gb,
         ranks=per_rank)
    return _sum_launches([res[t] for res in ranks
                          for t in ("zero1", "plain")])


# ----------------------------------------------------- decode under a mesh

#: the wrappers of decode_attention's partials mode (decode under a mesh),
#: counted beside KERNELS
MESH_KERNELS = ("decode_attention_partials", "decode_attention_merge")
#: the partials mode held and timed on one card: (label, B, KV, G, hd, S,
#: pos, window), the cache cut into 2 and 4 blocks of keys (qwen3-1.7b's
#: B 1 x 32768 keys, pos in the second half; gemma3-1b's hd 256 with its
#: window of 512 across a block boundary)
PARTIALS_CASES = (
    ("qwen3-1.7b B 1 x 32768", 1, 8, 2, 128, 32768, 20000, None),
    ("gemma3-1b B 4 x 1024, window 512", 4, 1, 4, 256, 1024, 600, 512),
)
#: the partials mode merged at bf16 is held within one bf16 ulp (2^-7 of
#: the value) of the case's largest entry: each output is an f32 value
#: rounded once, so two right answers differ by at most that; f32 at TOL
PARTIALS_BF16_REL = 2.0 ** -7


def partials_close(torch, got, ref, dtype: str, peak: float) -> bool:
    """A partials hold: f32 as allclose at TOL, bf16 within
    PARTIALS_BF16_REL of ``peak``, the reference's largest entry."""
    if dtype == "bfloat16":
        return (got - ref).abs().max().item() <= PARTIALS_BF16_REL * peak
    return torch.allclose(got, ref, atol=TOL[dtype], rtol=TOL[dtype])


#: decode steps a run of the dist_decode phases takes (32 until the
#: encdec and vlm phases joined the script: the time limit)
DECODE_STEPS = 16
#: dist_decode_qwen3, four gloo ranks on a (2, 2) mesh: (tag, B, S_max,
#: first position) -- B 1 over 32768 keys split by sequence over data
#: (and KV heads over model), the steps crossing the block boundary at
#: 16384 halfway; B 4 split by batch over data and heads over model.
#: Keys below the first position hold seeded random K / V.
DECODE_QWEN3_RUNS = (("b1", 1, 32768, 16384 - DECODE_STEPS // 2),
                     ("b4", 4, 2048, 1000))
#: dist_decode_gemma3 / dist_decode_olmoe, two gloo ranks on (1, 2):
#: (arch, B, S_max, first position) -- gemma3-1b's 1024 keys split by
#: sequence over model, positions 600-615 whose window of 512 straddles
#: the boundary at 512; olmoe-1b-7b with 32 of its 64 experts a rank
#: (the one-hot path across ranks) and 8 of its 16 KV heads
DECODE_PAIR_RUNS = (("gemma3-1b", 4, 1024, 600),
                    ("olmoe-1b-7b", 4, 2048, 1000))
DECODE_SEED = 251
#: f32 holds: greedy tokens equal, each step's logits within this of their
#: largest entry (the sharded sums run in another order)
DECODE_F32_TOL = 1e-4
#: bf16 holds, teacher-forced on the one-rank bf16 run's tokens: against
#: the f32 one-rank run forced on the same tokens (the same weights and
#: cache, rounded), each step's largest logit difference relative to the
#: step's largest entry stays within DECODE_BF16_FACTOR times the one-rank
#: bf16 run's own (the sharded sums round at other places; a bf16 run of
#: a random 28-layer model differs from f32 by percents, so no absolute
#: limit tells a fault from rounding -- the kernel path's holds use the
#: same rule, ``hold_kernel_path``)
DECODE_BF16_FACTOR = 1.5
#: dist_decode_qwen3's faulted run, which reads that limit against a
#: fault: the B 1 bf16 run again with block 1 of the keys (16384 on: none
#: before the boundary, up to 8 after it) left out of every layer's
#: merge, which must exceed the limit (at a factor of 2 it passed; block
#: 0, all but the newest keys, misses by far more: PERF.md)
DECODE_FAULTS = (("qwen3-1.7b/bfloat16/b1", (1,)),)


def mesh_counts(K) -> dict:
    return {**counts(K), **{n: getattr(K, n).launches for n in MESH_KERNELS}}


def decode_partials_phase(torch, K, dev, ptxas) -> dict:
    """decode_attention's partials mode on one card: the cache of each
    PARTIALS_CASES shape cut into 2 and 4 blocks, each block's partials
    (``decode_attention_partials`` at its key offset) merged by
    ``decode_attention_merge``, held against the whole-cache kernel and
    against the plain version (and the plain partials merged), at f32 and
    bf16; then one block's partials launch and the merge of its blocks
    timed beside the plain partials and the bound.  Returns the summary
    entry (launches filled in from the gloo phases)."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = dict.fromkeys(dtypes, 0.0)

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dtypes[dt])

    timed = []
    for label, B, KV, G, hd, S, pos, window in PARTIALS_CASES:
        for dt in dtypes:
            q = randn((B, 1, KV * G, hd), dt)
            k, v = randn((B, S, KV, hd), dt), randn((B, S, KV, hd), dt)
            p = torch.tensor(pos, dtype=torch.int32, device=dev)
            whole = K.decode_attention(q, k, v, p, window=window).float()
            plain = K.decode_attention_plain(q, k, v, p, window=window)
            peak = plain.float().abs().max().item()
            for nb in (2, 4):
                per = S // nb
                blocks = [(k[:, i * per:(i + 1) * per].contiguous(),
                           v[:, i * per:(i + 1) * per].contiguous(), i * per)
                          for i in range(nb)]
                parts = torch.stack([K.decode_attention_partials(
                    q, kb, vb, p, k_off=off, window=window)
                    for kb, vb, off in blocks])
                got = K.decode_attention_merge(parts, q, KV).float()
                pparts = torch.stack([K.decode_attention_partials_plain(
                    q, kb, vb, p, k_off=off, window=window)
                    for kb, vb, off in blocks])
                got_plain = K.decode_attention_merge_plain(pparts, q, KV)
                # the fault the hold must see: the block holding pos left
                # out of the merge
                own = pos // per
                faulted = K.decode_attention_merge(torch.cat(
                    [parts[:own], parts[own + 1:]]), q, KV).float()
                torch.cuda.synchronize()
                tol = PARTIALS_BF16_REL * peak if dt == "bfloat16" \
                    else TOL[dt]
                for what, ref in (("whole-cache kernel", whole),
                                  ("plain", plain.float()),
                                  ("plain partials merged",
                                   got_plain.float())):
                    err = (got - ref).abs().max().item()
                    ok = partials_close(torch, got, ref, dt, peak)
                    print(json.dumps({
                        "case": f"decode_attention_partials {dt} {label} "
                                f"{nb} blocks vs {what}",
                        "max_abs_err": err, "peak": peak, "tol": tol,
                        "ok": ok}), flush=True)
                    check(ok, f"decode_attention_partials {dt} {label} {nb} "
                          f"blocks vs {what}: max abs err {err} over {tol}")
                    worst[dt] = max(worst[dt], err)
                err = (faulted - plain.float()).abs().max().item()
                caught = not partials_close(torch, faulted, plain.float(), dt,
                                            peak)
                print(json.dumps({
                    "case": f"decode_attention_partials {dt} {label} {nb} "
                            f"blocks, block {own} dropped (a fault) vs plain",
                    "max_abs_err": err, "peak": peak, "tol": tol,
                    "caught": caught}), flush=True)
                check(caught, f"decode_attention_partials {dt} {label}: the "
                      f"hold does not see block {own} dropped ({err}, tol "
                      f"{tol})")
                if dt == "bfloat16" and nb == 2:
                    timed.append(_partials_time(torch, K, dev, label, q,
                                                blocks, p, window, pos))
            del q, k, v
            torch.cuda.empty_cache()
    t = timed[0]
    return {"name": "decode_attention_partials", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:92",
            "launches": None, "max_abs_err": max(worst.values()),
            "max_abs_err_by_dtype": worst,
            "tol": {"float32": TOL["float32"],
                    "bfloat16": f"{PARTIALS_BF16_REL} x the largest entry"},
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "merge_ms": t["merge_ms"],
            "whole_cache_ms": t["whole_cache_ms"],
            "timed_shape": t["shape"], "shapes": timed,
            "ptxas": ptxas_of(ptxas, "decode_attention")}


def _partials_time(torch, K, dev, label, q, blocks, p, window, pos) -> dict:
    """One rank's share at a bf16 PARTIALS_CASES shape cut into two blocks:
    the partials launch over the block holding ``pos`` (plan_splits'
    slices, no merge), the merge over both blocks' partials, the plain
    partials, and the whole-cache kernel, each with CUDA events over a
    graph of calls.  The bound: the block's visible keys' K and V read
    once, q read and the partials written once.  No PyTorch call computes
    the partials (m, l and the unnormalised accumulator), so no library
    time."""
    kb, vb, off = next(b for b in reversed(blocks) if b[2] <= pos)
    B, _, H, hd = q.shape
    KV = kb.shape[2]
    parts = torch.stack([K.decode_attention_partials(
        q, b[0], b[1], p, k_off=b[2], window=window) for b in blocks])
    ms, _ = cuda_time_ms(torch, lambda: K.decode_attention_partials(
        q, kb, vb, p, k_off=off, window=window), 50)
    merge_ms, _ = cuda_time_ms(
        torch, lambda: K.decode_attention_merge(parts, q, KV), 50)
    # the plain version reads pos on the host: given as an int, its
    # calls can be captured
    plain_ms, _ = cuda_time_ms(
        torch, lambda: K.decode_attention_partials_plain(
            q, kb, vb, pos, k_off=off, window=window), 5)
    whole_k = torch.cat([b[0] for b in blocks], dim=1)
    whole_v = torch.cat([b[1] for b in blocks], dim=1)
    whole_ms, _ = cuda_time_ms(torch, lambda: K.decode_attention(
        q, whole_k, whole_v, p, window=window), 50)
    lo = max(off, pos - window + 1 if window else 0)
    keys = max(0, min(pos, off + kb.shape[1] - 1) - lo + 1)
    n_split = parts.shape[1] // (B * KV * (H // KV) * (hd + 2))
    nbytes = (2 * B * KV * keys * hd + B * H * hd) * 2 \
        + B * H * n_split * (hd + 2) * 4
    bnd, by = bound_ms(nbytes, 4.0 * B * H * keys * hd, "bfloat16")
    out = dict(path=label, shape=f"{label}: one of 2 blocks, keys {off}-"
                                 f"{off + kb.shape[1] - 1}, pos {pos} bf16",
               ms=ms, merge_ms=merge_ms, plain_ms=plain_ms,
               whole_cache_ms=whole_ms, bound_ms=bnd, bound_by=by,
               bytes=nbytes, keys_read=keys, slices_per_block=n_split)
    emit("kernel_time", kernel="decode_attention_partials", **out)
    del whole_k, whole_v, parts
    return out


def _decode_draw(torch, cfg, dev, dtype, ctx=None):
    """``cfg``'s parameters drawn on the card from DECODE_SEED as
    ``init_params`` draws them, leaf by leaf; under ``ctx`` each leaf is
    cut to this rank's block as soon as it is drawn (a whole f32 olmoe
    does not fit twice beside the other rank's).  For the encdec and vlm
    families the zero-init leaves are set nonzero as
    ``set_nonzero_inits`` sets them (the vlm gates to GATE_VALUE), drawn
    whole from the same generator before the cut."""
    from repro_torch.models.common import _init_leaf, tree_map
    from repro_torch.models.transformer import model_specs

    gen = torch.Generator(device=dev).manual_seed(DECODE_SEED)
    dt = getattr(torch, dtype)
    cross = cfg.family in ("encdec", "vlm")

    def one(s):
        t = _init_leaf(s, dt, dev, gen)
        if cross and s.init == "zeros":     # as set_nonzero_inits sets them
            # the vlm gate: one entry a layer, whose logical dim is None
            t = (torch.full(s.shape, GATE_VALUE, device=dev)
                 if s.logical[-1] is None and s.shape[-1] == 1 else
                 torch.randn(s.shape, generator=gen, device=dev) * 0.2
                 ).to(dt)
        if ctx is None:
            return t
        return t[ctx.mesh.local_slices(ctx.spec(s.logical, s.shape),
                                       s.shape)].clone()

    return tree_map(one, model_specs(cfg))


def _fill_prefix(torch, cfg, cache, B, s_max, p0, ctx=None) -> None:
    """Seeded random K / V at the positions below ``p0`` of every KV leaf
    (drawn whole on the card layer by layer, in the cache's key order);
    under ``ctx`` each rank copies its block of them."""
    from repro_torch.models.common import tree_leaves

    blk = None if ctx is None else ctx.kv_block(
        (B, s_max, cfg.n_kv_heads, cfg.hd))
    i = 0
    for key, leaf in tree_leaves(cache):
        if key.rsplit("/", 1)[-1] not in ("k", "v"):
            continue
        layers = leaf if leaf.dim() == 5 else leaf[None]
        for layer in layers:
            g = torch.Generator(device=leaf.device).manual_seed(
                DECODE_SEED + 1 + i)
            i += 1
            whole = torch.randn((B, p0, cfg.n_kv_heads, cfg.hd), generator=g,
                                device=leaf.device).to(leaf.dtype)
            if blk is None:
                layer[:, :p0] = whole
                continue
            k0, k1 = blk.keys.start, min(blk.keys.stop, p0)
            if k1 > k0:
                layer[:, :k1 - k0] = whole[blk.rows, k0:k1, blk.heads]


def _decode_stub(torch, cfg, B: int, dev):
    """The frames or patches ``[B, CROSS_MEMORY, frontend_dim]`` an encdec
    or vlm decode run encodes into its memory (from DECODE_SEED + 3,
    every process the same); ``None`` for the other families."""
    if cfg.family not in CROSS_MEMORY:
        return None
    return stub_inputs(torch, cfg, B, CROSS_MEMORY[cfg.family], dev,
                       DECODE_SEED + 3)


def _decode_run(torch, K, cfg, params, dev, B, s_max, p0, first,
                forced=None, ctx=None, routing=None,
                steps: int = DECODE_STEPS) -> dict:
    """``steps`` serve steps from position ``p0`` over a cache whose
    keys below it are random (``_fill_prefix``): greedy from ``first``
    ``[B, 1]``, or teacher-forced on ``forced`` ``[B, steps + 1]``;
    encdec and vlm against the memory ``encode`` makes of the whole
    batch's ``_decode_stub`` (under ``ctx`` too), of which the cache takes
    this rank's rows.  The tokens, every step's logits (f32, on the host),
    ms a step (host clock to a synchronize), the launches and the peak
    memory.  ``routing`` (a pinned ``MoEProbe``, ``_pinned``) is entered
    around the steps."""
    from repro_torch.models.transformer import encode, init_cache
    from repro_torch.serve.step import make_serve_step

    step = make_serve_step(cfg)
    stub = _decode_stub(torch, cfg, B, dev)
    with torch.inference_mode():
        memory = None if stub is None else encode(params, cfg, stub)
        cache = init_cache(cfg, B, s_max, dev, mem_len=0 if memory is None
                           else memory.shape[1])
        if memory is not None:
            rows = slice(0, B) if ctx is None else ctx.batch_rows(B)[0]
            cache["memory"].copy_(memory[rows])
            del memory
        cache_bytes = _cache_bytes(cache)
        _fill_prefix(torch, cfg, cache, B, s_max, p0, ctx)
        toks, logits, ms = [first], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(K)
        with nullcontext() if routing is None else routing:
            for i in range(steps):
                tok = toks[-1] if forced is None else forced[:, i:i + 1]
                pos = torch.tensor(p0 + i, dtype=torch.int32, device=dev)
                t0 = time.perf_counter()
                nxt, lg, _ = step(params, cache, tok, pos)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                toks.append(nxt)
                logits.append(lg.cpu())
        launches = mesh_counts(K)
    return {"tokens": torch.cat(toks, dim=1).cpu(), "logits": logits,
            "ms": ms, "launches": launches, "cache_bytes": cache_bytes,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def _cache_bytes(cache) -> dict:
    """A cache tree's bytes: its KV leaves', its recurrent states' and its
    memory's (encdec, vlm)."""
    from repro_torch.models.common import tree_leaves

    out = {"kv": 0, "states": 0, "memory": 0}
    for key, t in tree_leaves(cache):
        kind = "kv" if key.rsplit("/", 1)[-1] in ("k", "v") else (
            "memory" if key == "memory" else "states")
        out[kind] += t.numel() * t.element_size()
    return out


def _rel_err(torch, got: list, want: list) -> float:
    """The largest over steps of a step's largest absolute difference
    relative to the step's largest entry."""
    return max((g - w).abs().max().item() / w.abs().max().item()
               for g, w in zip(got, want))


def _decode_hold(torch, got: dict, ref: dict, dtype: str) -> dict:
    """A rank's run against the one-rank runs: f32, greedy tokens equal and
    logits within DECODE_F32_TOL of each step's largest entry; bf16
    (teacher-forced), its distance from the f32 run forced on the same
    tokens within DECODE_BF16_FACTOR times the one-rank bf16 run's.  The
    numbers, and ``ok``."""
    want = ref["logits"] if dtype == "float32" else ref["f32_logits"]
    err = _rel_err(torch, got["logits"], want)
    cos = min(torch.nn.functional.cosine_similarity(
        g.reshape(1, -1), w.reshape(1, -1)).item()
        for g, w in zip(got["logits"], want))
    agree = sum(int((g.argmax(-1) == w.argmax(-1)).sum())
                for g, w in zip(got["logits"], want))
    equal = torch.equal(got["tokens"], ref["tokens"])
    if dtype == "float32":
        ok = equal and err <= DECODE_F32_TOL
    else:
        ok = err <= DECODE_BF16_FACTOR * ref["one_rank_err"]
    n = len(got["logits"]) * got["logits"][0].shape[0]
    return {"ok": bool(ok), "max_rel_err": err, "least_cosine": cos,
            "argmax_agree": f"{agree}/{n}", "tokens_equal": equal,
            "one_rank_err": ref.get("one_rank_err"),
            "ms_per_step": statistics.median(got["ms"][1:]),
            "peak_gb": got["peak_gb"], "launches": got["launches"],
            "cache_bytes": got["cache_bytes"]}


def _dist_config(arch: str):
    """``arch``'s registry config with its depth cut as DIST_LAYERS says
    where a distributed phase cuts it; ``ARCH:N:CF`` cuts it to N layers
    at capacity factor CF."""
    from repro_torch.configs import get_config

    arch, *cut = arch.split(":")
    cfg = get_config(arch).replace(**DIST_LAYERS.get(arch, {}))
    if cut:
        cfg = cfg.replace(n_layers=int(cut[0]),
                          capacity_factor=float(cut[1]))
    return cfg


def _decode_one_rank(torch, K, dev, runs, out: str, pin: bool = False,
                     steps: int = DECODE_STEPS) -> dict:
    """The one-rank runs (no mesh) of ``runs``, (arch, dtype, tag, B,
    S_max, first position, held), arch by arch from one f32 draw (bf16
    its rounding): greedy from seeded first tokens, and for each bf16 run
    the f32 model forced on its tokens.  What the ranks hold against goes
    to ``out/ref.pt``, with ``pin`` each run's routing (``_pinned``) for
    the ranks to take; the runs' numbers are returned."""
    from repro_torch.models.common import tree_map

    ref, mine = {}, {}
    for arch in dict.fromkeys(r[0] for r in runs):
        cfg = _dist_config(arch)
        p32 = _decode_draw(torch, cfg.replace(dtype="float32"), dev,
                           "float32")
        for dtype in ("float32", "bfloat16"):
            params = p32 if dtype == "float32" else tree_map(
                lambda t: t.to(torch.bfloat16), p32)
            c = cfg.replace(dtype=dtype)
            for a, dt, tag, B, s_max, p0, _ in runs:
                if (a, dt) != (arch, dtype):
                    continue
                first = torch.randint(0, c.vocab_size, (B, 1), device=dev,
                                      generator=torch.Generator(device=dev)
                                      .manual_seed(DECODE_SEED))
                routing = _pinned(torch) if pin else None
                r = _decode_run(torch, K, c, params, dev, B, s_max, p0,
                                first, routing=routing, steps=steps)
                key = f"{arch}/{dtype}/{tag}"
                ref[key] = {"tokens": r["tokens"], "logits": r["logits"]}
                if dtype == "bfloat16":
                    toks = r["tokens"].to(dev)
                    f32 = _decode_run(torch, K, cfg.replace(dtype="float32"),
                                      p32, dev, B, s_max, p0, toks[:, :1],
                                      toks, steps=steps)
                    ref[key] = {"tokens": r["tokens"],
                                "f32_logits": f32["logits"],
                                "one_rank_err": _rel_err(
                                    torch, r["logits"], f32["logits"])}
                if pin:
                    ref[key]["routing"] = [t.cpu() for t in routing.recorded]
                mine[key] = {
                    "ms_per_step": statistics.median(r["ms"][1:]),
                    "peak_gb": r["peak_gb"], "launches": r["launches"],
                    "cache_bytes": r["cache_bytes"],
                    "err_from_f32": ref[key].get("one_rank_err")}
            del params
        del p32
        torch.cuda.empty_cache()
    torch.save(ref, os.path.join(out, "ref.pt"))
    return mine


class _DroppedBlock:
    """While entered, the decode step's merge leaves out block ``i`` of
    the all-gathered partials (a fault for DECODE_FAULTS)."""

    def __init__(self, torch, i: int):
        from repro_torch.models import layers

        self.torch, self.i, self.layers = torch, i, layers
        self.real = layers.decode_attention_merge

    def __enter__(self):
        torch, i, real = self.torch, self.i, self.real
        self.layers.decode_attention_merge = lambda parts, q, kv: real(
            torch.cat([parts[:i], parts[i + 1:]]), q, kv)

    def __exit__(self, *exc):
        self.layers.decode_attention_merge = self.real


def _decode_ranks(torch, K, dev, runs, shape, out: str,
                  faults: tuple = (), mesh=None, multi_pod: bool = False,
                  steps: int = DECODE_STEPS) -> dict:
    """This rank's runs of ``runs`` on a ``shape`` (data, model) mesh (or
    ``mesh``) under ``launch.dryrun.serve_rules`` (``multi_pod``: the
    multi-pod rules), each held against the one-rank runs in ``ref.pt``
    (``_decode_hold``); bf16 runs are forced on the one-rank bf16 run's
    tokens.  ``faults``: (run key, dropped blocks) -- that run again with
    each block left out of the merge (``_DroppedBlock``), its distance
    from f32 recorded beside the sound run's."""
    from repro_torch.distributed import activate
    from repro_torch.launch.dryrun import serve_rules
    from repro_torch.launch.mesh import make_local_mesh

    if mesh is None:
        mesh = make_local_mesh(*shape, device=dev)
    ref = torch.load(os.path.join(out, "ref.pt"), mmap=True)
    res, params, drawn = {}, None, None
    for arch, dtype, tag, B, s_max, p0, held in runs:
        cfg = _dist_config(arch).replace(dtype=dtype)
        with activate(mesh, serve_rules(cfg, mesh, B,
                                        multi_pod=multi_pod)) as ctx:
            if drawn != (arch, dtype):
                params = None
                torch.cuda.empty_cache()
                params = _decode_draw(torch, cfg, dev, dtype, ctx)
                drawn = (arch, dtype)
            r = ref[f"{arch}/{dtype}/{tag}"]
            toks = r["tokens"].to(dev)
            routing = (_pinned(torch, r["routing"]) if "routing" in r
                       else None)
            got = _decode_run(torch, K, cfg, params, dev, B, s_max, p0,
                              toks[:, :1], None if dtype == "float32"
                              else toks, ctx, routing, steps)
            blk = ctx.kv_block((B, s_max, cfg.n_kv_heads, cfg.hd))
            faulted = {}
            for drop in dict(faults).get(f"{arch}/{dtype}/{tag}", ()):
                with _DroppedBlock(torch, drop):
                    bad = _decode_run(torch, K, cfg, params, dev, B, s_max,
                                      p0, toks[:, :1], toks, ctx)
                faulted[drop] = _rel_err(torch, bad["logits"],
                                         r["f32_logits"])
        rec = _decode_hold(torch, got, r, dtype)
        rec["faulted"] = faulted
        if routing is not None:
            rec["routing_flips"] = routing.n_flips()
        rec.update(held=held, block=[(sl.start, sl.stop) for sl in
                                     (blk.rows, blk.keys, blk.heads)],
                   seq_axes=blk.seq_axes, batch_axes=blk.batch_axes,
                   device=str(dev))
        res[f"{arch}/{dtype}/{tag}"] = rec
    return res


def _decode_runs_qwen3():
    return [("qwen3-1.7b", dt, tag, B, s_max, p0, True)
            for dt in ("float32", "bfloat16")
            for tag, B, s_max, p0 in DECODE_QWEN3_RUNS]


def _decode_runs_pair():
    # olmoe's bf16 run is timed, not held: a one-ulp change of its router
    # input reorders near-tied experts (PERF.md, PR 20's MoEProbe)
    return [(arch, dt, "b4", B, s_max, p0,
             dt == "float32" or not arch.startswith("olmoe"))
            for arch, B, s_max, p0 in DECODE_PAIR_RUNS
            for dt in ("float32", "bfloat16")]


def decode_qwen3_rank(torch, K, dev, rank: int, out: str) -> dict:
    """``--gloo-program decode_qwen3``: one of four ranks of
    dist_decode_qwen3 (a (2, 2) mesh)."""
    return _decode_ranks(torch, K, dev, _decode_runs_qwen3(), (2, 2), out,
                         DECODE_FAULTS)


def decode_pair_rank(torch, K, dev, rank: int, out: str) -> dict:
    """``--gloo-program decode_pair``: one of two ranks of
    dist_decode_gemma3 and dist_decode_olmoe (a (1, 2) mesh)."""
    return _decode_ranks(torch, K, dev, _decode_runs_pair(), (1, 2), out)


def _per_step(arch: str, B: int, s_max: int, shape) -> dict:
    """Each kernel's launches a decode step of a rank: the attention
    through the partials mode where the cache splits by sequence, the
    whole-cache kernel elsewhere; four norms a layer and the final one."""
    from repro_torch.distributed import Mesh
    from repro_torch.distributed.context import KV_CACHE_LOGICAL, ShardingCtx
    from repro_torch.launch.dryrun import serve_rules

    cfg = _dist_config(arch)
    mesh = Mesh(shape, ("data", "model"))
    ctx = ShardingCtx(mesh, serve_rules(cfg, mesh, B))
    lay = ctx.layout(KV_CACHE_LOGICAL, (B, s_max, cfg.n_kv_heads, cfg.hd))
    L = cfg.n_layers
    seq = bool(lay[1])
    return {"decode_attention": 0 if seq else L,
            "decode_attention_partials": L if seq else 0,
            "decode_attention_merge": L if seq else 0,
            "rmsnorm": 4 * L + 1}


def dist_decode_phase(torch, K, dev, mesh) -> dict:
    """Decode under a mesh on the card: ``serve_graph_mesh`` (the captured
    step under ``serve_rules`` on the 1-rank NCCL mesh against the eager
    step), then ``dist_decode_qwen3`` (four gloo ranks, (2, 2)) and
    ``dist_decode_gemma3`` / ``dist_decode_olmoe`` (two gloo ranks, (1,
    2)), each rank's runs held against this process's one-rank runs of
    the same weights and cache.  The ranks' collectives are gloo's,
    through the host, four (two) processes on one card: their times are
    not NVLink's.  Returns the launches by path."""
    by_path = {"serve_graph_mesh": serve_graph_mesh_phase(torch, K, dev,
                                                          mesh)}
    for program, world, shape, runs, phases in (
            ("decode_qwen3", 4, (2, 2), _decode_runs_qwen3(),
             ("dist_decode_qwen3",)),
            ("decode_pair", 2, (1, 2), _decode_runs_pair(),
             ("dist_decode_gemma3", "dist_decode_olmoe"))):
        out = tempfile.mkdtemp(prefix="chip_smoke_decode_")
        try:
            one = _decode_one_rank(torch, K, dev, runs, out)
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = _spawn_ranks(torch, program, world, out)
            seconds = time.perf_counter() - t0
        finally:
            shutil.rmtree(out, ignore_errors=True)
        for phase in phases:
            arch = {"dist_decode_qwen3": "qwen3-1.7b",
                    "dist_decode_gemma3": "gemma3-1b",
                    "dist_decode_olmoe": "olmoe-1b-7b"}[phase]
            report, recs = {}, []
            for a, dtype, tag, B, s_max, p0, held in runs:
                if a != arch:
                    continue
                key = f"{arch}/{dtype}/{tag}"
                want = {k: DECODE_STEPS * n for k, n in _per_step(
                    arch, B, s_max, shape).items()}
                rows = []
                for r, res in enumerate(ranks):
                    rec = res[key]
                    check(rec["device"].startswith("cuda"),
                          f"{phase} {key}: rank {r} ran on {rec['device']}")
                    for name, n in want.items():
                        check(rec["launches"][name] == n,
                              f"{phase} {key}: rank {r} launched {name} "
                              f"{rec['launches'][name]} times, expected {n}")
                    numbers = {k: rec[k] for k in (
                        "tokens_equal", "max_rel_err", "one_rank_err",
                        "least_cosine", "argmax_agree")}
                    check(rec["ok"] or not held, f"{phase} {key}: rank {r} "
                          f"against one rank: {numbers}")
                    limit = DECODE_BF16_FACTOR * (rec["one_rank_err"] or 0)
                    for drop, err in rec["faulted"].items():
                        check(err > limit, f"{phase} {key}: rank {r}'s bf16 "
                              f"limit {limit} does not see block {drop} "
                              f"dropped ({err})")
                    rows.append({k: rec[k] for k in (
                        "ok", "held", "tokens_equal", "max_rel_err",
                        "one_rank_err", "least_cosine", "argmax_agree",
                        "ms_per_step", "peak_gb", "block", "seq_axes",
                        "batch_axes", "faulted")})
                    recs.append(rec)
                report[f"{dtype}/{tag}"] = {
                    "batch": B, "s_max": s_max, "positions": [
                        p0, p0 + DECODE_STEPS - 1], "ranks": rows,
                    "launches_a_rank": recs[-1]["launches"],
                    "one_rank": one[key]}
            emit(phase, arch=arch, mesh=list(shape), ranks=world,
                 backend="gloo (through the host, ranks sharing one card, "
                 "not NVLink)", steps=DECODE_STEPS,
                 f32_tol=DECODE_F32_TOL, bf16_factor=DECODE_BF16_FACTOR,
                 spawn_s=seconds, **report)
            by_path[phase] = _sum_launches(recs)
    return by_path


def serve_graph_mesh_phase(torch, K, dev, mesh) -> dict:
    """``serve_graph_mesh``: qwen3-1.7b at full size (random weights from
    DECODE_SEED), ``generate`` under ``serve_rules`` on the 1-rank NCCL
    (1, 1) mesh, every step a replay of the captured step, against the
    same ``generate`` run eagerly under the mesh and without it: tokens
    identical; launches per replay exact."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import activate
    from repro_torch.launch.dryrun import serve_rules
    from repro_torch.launch.serve import generate

    cfg = get_config("qwen3-1.7b")
    B, S0, gen = LARGE_GENERATE
    params = _decode_draw(torch, cfg, dev, cfg.dtype)
    prompt = prompt_for(torch, cfg, LARGE_GENERATE, dev, DECODE_SEED)
    plain = generate(cfg, params, prompt, gen, device=dev, capture=False)
    with activate(mesh, serve_rules(cfg, mesh, B)):
        eager = generate(cfg, params, prompt, gen, device=dev, capture=False)
        reset_counts(K)
        log = []
        t0 = time.perf_counter()
        captured = generate(cfg, params, prompt, gen, device=dev,
                            step_log=log)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    step = log[0]
    per = {"decode_attention": cfg.n_layers, "rmsnorm": 4 * cfg.n_layers + 1}
    for name, n in per.items():
        check(step.launches[name] == n, f"serve_graph_mesh {name}: "
              f"{step.launches[name]} launches a replay, expected {n}")
    check(torch.equal(captured, eager) and torch.equal(eager, plain),
          "serve_graph_mesh: the captured step's tokens under the mesh differ "
          "from the eager step's")
    launches = {name: step.launches[name] * step.replays for name in KERNELS}
    emit("serve_graph_mesh", arch=cfg.name, batch=B, prompt=S0, generated=gen,
         mesh=[1, 1], backend="nccl", replays=step.replays,
         launches_a_replay={k: step.launches[k] for k in KERNELS},
         seconds=seconds, tokens_equal=True)
    del params
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------ hybrid and xLSTM under a mesh

#: dist_tp_zamba2 / dist_tp_xlstm / dist_decode_zamba2 /
#: dist_decode_xlstm: two gloo ranks, spawned once for the four phases.
#: The config changes of the depth a distributed phase runs at (zamba2-7b:
#: one hybrid group of six Mamba2 blocks and the shared attention block,
#: plus one tail Mamba2 block, 81 -> 7; xlstm-125m 12 -> 4, two (mLSTM,
#: sLSTM) groups, for the time limit; whisper-large-v3
#: 32 + 32 -> 2 + 2 layers (4 + 4 until the multi-pod phase joined the
#: script); llama-3.2-vision-11b 40 -> 5, one group of 4 self-attention
#: layers and its gated cross-attention layer; since the multi-pod phase
#: joined, dist_decode_gemma3's gemma3-1b 26 -> 13 layers (two of its
#: five-local, one-global groups and one local layer) and
#: dist_decode_olmoe's olmoe-1b-7b 16 -> 8)
DIST_LAYERS = {"zamba2-7b": {"n_layers": 7}, "xlstm-125m": {"n_layers": 4},
               "gemma3-1b": {"n_layers": 13}, "olmoe-1b-7b": {"n_layers": 8},
               "whisper-large-v3": {"n_layers": 2, "n_encoder_layers": 2},
               "llama-3.2-vision-11b": {"n_layers": 5}}
#: per arch: (bf16 train shape, the f32 hold's config changes, its shape)
#: -- zamba2 B 1 x S 2048; xlstm B 2 x S 64 (its time loop is bound by
#: the host's launches; S 256 took four times as long, PERF.md); the f32 holds
#: run 2 layers: zamba2 as two (Mamba2, shared attention) groups (its
#: period cut 6 -> 1, so the shared block runs), xlstm one mLSTM + sLSTM
#: group.  zamba2 amplifies rounding: at 7 layers the TP run's reordered
#: sums moved its f32 gradients past TP_F32_TOL (PERF.md), so each
#: f32 hold also reports the one-rank gradients' move under weights moved
#: by 1e-7 of themselves (``floor``)
RECURRENT_TP = {"zamba2-7b": ((1, 2048), {"n_layers": 2,
                                          "hybrid_period": 1}, (1, 512)),
                "xlstm-125m": ((2, 64), {"n_layers": 2}, (2, 128))}
#: the bf16 gradient hold: a rank's gradient blocks, as one vector, no
#: farther from the f32 gradient of the same weights (1 - cosine) than
#: this many times the one-rank bf16 run's (``hold_kernel_path``'s factor)
TP_BF16_FACTOR = 2.0
RECURRENT_ARCHS = tuple(RECURRENT_TP)
#: decode: B 4 from position 0 for DECODE_STEPS steps, on (1, 2) (heads,
#: d_inner and vocabulary over model) and on (2, 1) (the batch rows, and
#: every recurrent state with them, over data)
RECURRENT_DECODE_B = 4
RECURRENT_MESHES = ((1, 2), (2, 1))
RECURRENT_SEED = 263


def _family_tp_cfgs(arch: str):
    """(tag, config, global shape, seed) of ``arch``'s bf16 and f32 TP
    runs (RECURRENT_TP, CROSS_TP)."""
    shape, f32_cfg, shape32 = {**RECURRENT_TP, **CROSS_TP}[arch]
    cfg = _dist_config(arch)
    return ((("bf16", cfg, shape, RECURRENT_SEED),
             ("f32", cfg.replace(dtype="float32", **f32_cfg), shape32,
              RECURRENT_SEED + 2)))


def _family_tp_runs(torch, K, dev, mesh, arch) -> dict:
    """``arch``'s bf16 and f32 TP runs on ``mesh`` (``_sharded_train``),
    each record with its step-0 gradients (on the host) and its slices."""
    res = {}
    for tag, c, shape, seed in _family_tp_cfgs(arch):
        state, slices, rec = _sharded_train(
            torch, K, c, dev, mesh, _tp_opt(TP_STEPS), seed,
            _tp_batches(torch, c, dev, shape, seed + 1))
        del state
        torch.cuda.empty_cache()
        rec["slices"] = slices
        res[tag] = rec
    return res


def _one_rank_tp(torch, K, dev, mesh, archs) -> tuple:
    """Each arch's one-rank TP runs on ``mesh`` (the 1-rank NCCL mesh), the
    f32 gradients of its bf16 run's weights (``_grads0``, the bf16 hold's
    reference) and, in its f32 record, the ``floor``: the one-rank f32
    gradients' largest move under weights moved by 1e-7 of themselves."""
    one, g32 = {}, {}
    for arch in archs:
        one[arch] = _family_tp_runs(torch, K, dev, mesh, arch)
        (_, c, shape, seed), (_, c32, shape32, seed32) = \
            _family_tp_cfgs(arch)
        g32[arch] = _grads0(torch, c, dev, seed, _tp_batches(
            torch, c, dev, shape, seed + 1)[0])
        moved = _grads0(torch, c32, dev, seed32, _tp_batches(
            torch, c32, dev, shape32, seed32 + 1)[0], move=1e-7)
        one[arch]["f32"]["floor"] = max(
            ((k, _dist_from(torch, g, one[arch]["f32"]["grads0"][k]))
             for k, g in moved.items()), key=lambda kv: kv[1])
        del moved
    return one, g32


def _grads0(torch, cfg, dev, seed: int, batch: dict,
            move: float = 0.0) -> dict:
    """Step 0's gradients in f32, on the host, of ``cfg``'s weights as
    ``_sharded_train`` draws them from ``seed`` (upcast), on the global
    ``batch``; with ``move`` each weight moved by that much of itself
    times a seeded normal draw."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import lm_loss
    from repro_torch.weights import unflatten

    full = _draw_full(torch, cfg, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    flat = {}
    for k, t in tree_leaves(full):
        t = t.float()
        if move:
            t = t * (1 + move * torch.randn(t.shape, generator=gen,
                                            device=dev))
        flat[k] = t.requires_grad_(True)
    del full
    loss = lm_loss(unflatten(flat), cfg.replace(dtype="float32"), batch)
    keys = sorted(flat)
    grads = torch.autograd.grad(loss, [flat[k] for k in keys])
    out = {k: g.cpu() for k, g in zip(keys, grads)}
    del flat, grads, loss
    torch.cuda.empty_cache()
    return out


def _dist_from(torch, got, want) -> float:
    """The largest absolute difference relative to ``want``'s largest
    entry."""
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _hold_tp(torch, tag: str, rec: dict, one: dict, g32) -> tuple:
    """A rank's TP run against the one-rank run: (ok, numbers).  f32:
    every step's loss, step 0's clip norm and step 0's gradient of every
    leaf on the rank's block within TP_F32_TOL relative, beside the
    one-rank gradients' move under weights moved by 1e-7 (``floor``); the
    later clip norms reported (after an update zamba2's move by rounding
    amplified, as the reference's own layouts' do on the CPU).  bf16: every
    loss within TP_LOSS_RTOL, and the rank's gradient blocks, all leaves as
    one vector, no farther from the f32 gradient of the same weights
    (``g32``; 1 - cosine) than TP_BF16_FACTOR times the one-rank bf16
    run's blocks; each leaf's cosine against the one-rank run's reported
    (Mamba2's per-head leaves are sums of 2048 x 64 products that cancel,
    which bf16 rounds far from f32 on one rank as on two: a leaf's bf16
    cosine does not tell a fault from rounding, the f32 hold does)."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"],
                                                 one["losses"]))
    gn = [abs(a - b) / abs(b) for a, b in zip(rec["grad_norms"],
                                              one["grad_norms"])]
    if tag == "f32":
        worst = max(((k, _dist_from(torch, g, one["grads0"][k][
            rec["slices"][k]].float())) for k, g in rec["grads0"].items()),
            key=lambda kv: kv[1])
        ok = rel <= TP_F32_TOL and gn[0] <= TP_F32_TOL \
            and worst[1] <= TP_F32_TOL
        return ok, {"loss_rel_err": rel, "grad_norm_rel_err": gn,
                    "worst_leaf": worst, "floor": one["floor"]}
    cos, sums = {}, dict.fromkeys(("tp.f32", "one.f32", "tp.tp", "one.one",
                                   "f32.f32", "tp.one"), 0.0)
    for k, g in rec["grads0"].items():
        sl = rec["slices"][k]
        v = {"tp": g.float().reshape(-1),
             "one": one["grads0"][k][sl].float().reshape(-1),
             "f32": g32[k][sl].reshape(-1)}
        for key in sums:
            a, b = key.split(".")
            sums[key] += float(v[a] @ v[b])
        cos[k] = float(torch.nn.functional.cosine_similarity(
            v["tp"], v["one"], dim=0))
    cosine = {pair: sums[f"{a}.{b}"] / math.sqrt(
        sums[f"{a}.{a}"] * sums[f"{b}.{b}"]) for pair, (a, b) in (
        ("tp_vs_f32", ("tp", "f32")), ("one_rank_vs_f32", ("one", "f32")),
        ("tp_vs_one_rank", ("tp", "one")))}
    ok = rel <= TP_LOSS_RTOL and 1 - cosine["tp_vs_f32"] <= \
        TP_BF16_FACTOR * (1 - cosine["one_rank_vs_f32"])
    return ok, {"loss_rel_err": rel, "grad_norm_rel_err": gn,
                "gradient_cosine": cosine,
                "least_leaf_cosines_vs_one_rank": sorted(
                    cos.items(), key=lambda kv: kv[1])[:4],
                "leaves_below_cos_min": sum(c <= TP_COS for c in
                                            cos.values())}


def _decode_runs_recurrent():
    return [(arch, dt, "b4", RECURRENT_DECODE_B, DECODE_STEPS, 0, True)
            for arch in RECURRENT_ARCHS for dt in ("float32", "bfloat16")]


def recurrent_rank(torch, K, dev, rank: int, out: str) -> dict:
    """``--gloo-program recurrent``: one of two ranks of dist_tp_zamba2,
    dist_tp_xlstm (a (1, 2) mesh: the runs and their step-0 gradient
    blocks, held by the main process) and dist_decode_zamba2 /
    dist_decode_xlstm (on (1, 2), then on (2, 1), held against this
    process's one-rank runs saved in ``out``)."""
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(1, 2, device=dev)
    res = {arch: _family_tp_runs(torch, K, dev, mesh, arch)
           for arch in RECURRENT_ARCHS}
    for shape in RECURRENT_MESHES:
        res[shape] = _decode_ranks(torch, K, dev, _decode_runs_recurrent(),
                                   shape, out)
    return res


def _recurrent_launches(cfg, train: bool, seq_split: bool = False) -> dict:
    """Each kernel's launches a step of a hybrid or ssm config: a train
    step with remat="full" runs each group's blocks forward and again in
    the recompute, the tail's once, and the final norm; a decode step
    every block once, its shared attention through the partials mode
    where the cache splits by sequence."""
    from repro_torch.models.transformer import program_for

    grp, n_groups, rem = program_for(cfg)
    out = dict.fromkeys(KERNELS + MESH_KERNELS, 0)
    for kinds, times in ((grp, (2 if train else 1) * n_groups), (rem, 1)):
        for kind in kinds:
            out["rmsnorm"] += times * (2 if kind == "shared_attn" or (
                kind == "slstm" and cfg.d_ff > 0) else 1)
            if kind == "mamba" and train:
                out["ssm_scan"] += times
            if kind == "shared_attn":
                names = ("flash_attention",) if train else (
                    MESH_KERNELS if seq_split else ("decode_attention",))
                for name in names:
                    out[name] += times
    out["rmsnorm"] += 1
    return out


def dist_recurrent_phase(torch, K, dev, mesh) -> dict:
    """``dist_tp_zamba2`` / ``dist_tp_xlstm``: zamba2-7b at full width
    (7 of its 81 layers: one hybrid group and one tail block) and
    xlstm-125m at full size, tensor parallel over two gloo ranks on the
    card ((1, 2): 56 of 112 SSM heads, 16 of 32 shared-block heads, 7,168
    of 14,336 MLP columns and 16,000 of 32,000 vocabulary rows a rank for
    zamba2; the mLSTM's 768 of 1,536 ``d_in`` columns and 25,152 of 50,304
    vocabulary rows for xlstm), against this process's run of the same
    batches on the 1-rank NCCL (1, 1) mesh at bf16 and at f32, as
    ``dist_tp_qwen3`` holds them.  ``dist_decode_zamba2`` /
    ``dist_decode_xlstm``: decode under ``serve_rules`` on (1, 2) and on
    (2, 1) (each rank's batch rows, with their recurrent states), f32 and
    bf16, DECODE_STEPS steps, against this process's one-rank runs as
    ``dist_decode_phase`` holds them; each rank's cache bytes (recurrent
    states, KV) beside the whole cache's.  One spawn of two ranks runs the
    four phases.  Returns the launches by path."""
    out = tempfile.mkdtemp(prefix="chip_smoke_recurrent_")
    failed = []
    try:
        one, g32 = _one_rank_tp(torch, K, dev, mesh, RECURRENT_ARCHS)
        runs = _decode_runs_recurrent()
        one_dec = _decode_one_rank(torch, K, dev, runs, out)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = _spawn_ranks(torch, "recurrent", 2, out)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    by_path = {}
    for arch in RECURRENT_ARCHS:
        phase = arch.split("-")[0]
        by_path[f"dist_tp_{phase}"] = _hold_tp_ranks(
            torch, f"dist_tp_{phase}", arch, ranks, one[arch], g32[arch],
            (1, 2), seconds, failed, _recurrent_launches)
    del one, g32
    for arch in RECURRENT_ARCHS:
        phase = f"dist_decode_{arch.split('-')[0]}"
        by_path[phase] = _hold_decode_ranks(
            torch, phase, arch, ranks, runs, one_dec, RECURRENT_MESHES,
            seconds, failed, _recurrent_launches)
    # every line is printed before a hold fails, so one run reads them all
    check(not failed, "; ".join(failed))
    return by_path


def _hold_tp_ranks(torch, phase: str, arch: str, ranks: list, one: dict,
                   g32: dict, shape: tuple, seconds: float, failed: list,
                   launches) -> dict:
    """Every rank's bf16 and f32 TP runs of ``arch`` on a ``shape`` mesh
    held against the one-rank runs (``_hold_tp``) and their launches a
    step against ``launches(cfg, True)``; the phase's line is emitted,
    each failure appended to ``failed``.  Returns the launches."""
    from repro_torch.configs import get_config

    report, recs = {}, []
    for tag, c, tshape, _ in _family_tp_cfgs(arch):
        want = {k: TP_STEPS * n for k, n in launches(c, True).items()
                if k in KERNELS}
        mine = one[tag]
        for r, res in enumerate(ranks):
            rec = res[arch][tag]
            ok, numbers = _hold_tp(torch, tag, rec, mine,
                                   g32 if tag == "bf16" else None)
            bad = [name for name, n in want.items()
                   if rec["launches"][name] != n]
            if not (ok and not bad and rec["device"].startswith("cuda")):
                failed.append(f"{phase} {tag}: rank {r} on "
                              f"{rec['device']}, launches {bad} off "
                              f"({rec['launches']} vs {want}): {numbers}")
            report.setdefault(tag, []).append({
                "ok": ok, "losses": rec["losses"],
                "ms_per_step": rec["ms"], "peak_gb": rec["peak_gb"],
                "launches": rec["launches"], **numbers})
            recs.append(rec)
        report[f"{tag}_one_rank"] = {
            "losses": mine["losses"], "ms_per_step": mine["ms"],
            "peak_gb": mine["peak_gb"], "n_layers": c.n_layers,
            "batch": tshape[0], "seq": tshape[1]}
    emit(phase, arch=arch, full_n_layers=get_config(arch).n_layers,
         cut=DIST_LAYERS.get(arch, {}), steps=TP_STEPS, mesh=list(shape),
         backend=f"gloo (through the host, {len(ranks)} ranks on one card, "
         f"not NVLink)", one_rank_backend="nccl (1, 1)",
         loss_rtol=TP_LOSS_RTOL, cos_min=TP_COS, f32_tol=TP_F32_TOL,
         bf16_factor=TP_BF16_FACTOR, spawn_s=seconds, **report)
    return _sum_launches(recs)


def _hold_decode_ranks(torch, phase: str, arch: str, ranks: list,
                       runs: list, one_dec: dict, meshes: tuple,
                       seconds: float, failed: list, launches,
                       axes: tuple = ("data", "model"),
                       multi_pod: bool = False,
                       steps: int = DECODE_STEPS) -> dict:
    """Every rank's decode runs of ``arch`` on each of ``meshes`` (the
    ranks' results keyed by mesh shape, of ``axes``) as ``_decode_ranks``
    held them, their launches against ``launches(cfg, False, cache split
    by sequence)`` a step; the phase's line is emitted, each failure
    appended to ``failed``.  Returns the launches."""
    from repro_torch.distributed import Mesh
    from repro_torch.distributed.context import KV_CACHE_LOGICAL, ShardingCtx
    from repro_torch.launch.dryrun import serve_rules

    cfg = _dist_config(arch)
    report, recs = {}, []
    for shape in meshes:
        m = Mesh(shape, axes)
        for a, dtype, tag, B, s_max, p0, held in runs:
            if a != arch:
                continue
            lay = ShardingCtx(m, serve_rules(cfg, m, B, multi_pod)).layout(
                KV_CACHE_LOGICAL, (B, s_max, cfg.n_kv_heads, cfg.hd))
            want = {k: steps * n for k, n in launches(
                cfg, False, bool(lay[1])).items()}
            key = f"{arch}/{dtype}/{tag}"
            whole = one_dec[key]["cache_bytes"]
            rows = []
            for r, res in enumerate(ranks):
                rec = res[shape][key]
                bad = [name for name, n in want.items()
                       if rec["launches"][name] != n]
                numbers = {k: rec[k] for k in (
                    "tokens_equal", "max_rel_err", "one_rank_err",
                    "least_cosine", "argmax_agree", "cache_bytes")}
                # encdec, vlm: the memory is the rank's batch rows and the
                # KV leaves its block (every mesh here splits them evenly)
                parts = math.prod(m.shape[a] for a in rec["batch_axes"])
                if whole["memory"] and (
                        rec["cache_bytes"]["memory"] * parts
                        != whole["memory"] or rec["cache_bytes"]["kv"]
                        * len(ranks) != whole["kv"]):
                    bad.append("cache blocks")
                if bad or not (rec["ok"] or not held) or not \
                        rec["device"].startswith("cuda"):
                    failed.append(f"{phase} {shape} {key}: rank {r} on "
                                  f"{rec['device']}, launches {bad} off "
                                  f"({rec['launches']} vs {want}): "
                                  f"{numbers}")
                rows.append({k: rec[k] for k in (
                    "ok", "tokens_equal", "max_rel_err", "one_rank_err",
                    "least_cosine", "argmax_agree", "ms_per_step",
                    "peak_gb", "cache_bytes", "batch_axes",
                    "routing_flips") if k in rec})
                recs.append(rec)
            report[f"{'x'.join(map(str, shape))}/{dtype}"] = {
                "batch": B, "s_max": s_max, "positions": [
                    p0, p0 + steps - 1], "ranks": rows,
                "launches_a_rank": recs[-1]["launches"],
                "whole_cache_bytes": one_dec[key]["cache_bytes"],
                "one_rank": one_dec[key]}
    emit(phase, arch=arch, n_layers=cfg.n_layers, steps=steps,
         meshes=[list(m) for m in meshes], backend=f"gloo (through the "
         f"host, {len(ranks)} ranks on one card, not NVLink)",
         f32_tol=DECODE_F32_TOL, bf16_factor=DECODE_BF16_FACTOR,
         spawn_s=seconds, **report)
    return _sum_launches(recs)


# ------------------------------- whisper and llama-vision under a mesh

#: the stub rows of the encdec and vlm memory in the distributed phases
#: (by family): whisper-large-v3's 1500 frames, llama-3.2-vision-11b's
#: 1024 patches, each of frontend_dim 1280
CROSS_MEMORY = {"encdec": WHISPER_FRAMES, "vlm": VLM_PATCHES}
#: per arch, as RECURRENT_TP: (bf16 train shape, the f32 hold's config
#: changes, its shape) -- whisper B 2 x 448 tokens over 1500 frames, f32
#: at 2 + 2 layers and 128 tokens; llama-vision B 1 x S 2048 over 1024
#: patches, f32 at 2 layers with cross_attn_period 2 (at its period of 5,
#: 2 layers hold no cross-attention: program_for makes 2 // 5 = 0
#: groups) and S 512
CROSS_TP = {"whisper-large-v3": ((2, WHISPER_TOKENS),
                                 {"n_layers": 2, "n_encoder_layers": 2},
                                 (2, 128)),
            "llama-3.2-vision-11b": ((1, 2048), {"n_layers": 2,
                                                 "cross_attn_period": 2},
                                     (1, 512))}
CROSS_ARCHS = tuple(CROSS_TP)
#: dist_decode_whisper / dist_decode_llama_vision: B 4 against the model's
#: own memory (the encoder over 4 x 1500 frames, 4 x 1024 projected
#: patches), DECODE_STEPS steps from (S_max, first position): whisper to
#: its 448-token limit, llama-vision to 2048; the keys below the first
#: position random (``_fill_prefix``), on (1, 2) and (2, 1)
CROSS_DECODE = {"whisper-large-v3": (448, 448 - DECODE_STEPS),
                "llama-3.2-vision-11b": (2048, 2048 - DECODE_STEPS)}
CROSS_MESHES = ((1, 2), (2, 1))


def _cross_launches(cfg, train: bool, seq_split: bool = False) -> dict:
    """Each kernel's launches a step of an encdec or vlm config: a train
    step with remat="full" runs each group's blocks forward and again in
    the recompute (the encoder's layers likewise), the tail's once, and
    the final norm; self- and cross-attention through flash; a decode step
    every block once, its self-attention through the partials mode where
    the cache splits by sequence and its one-query cross-attention through
    decode_attention.  LayerNorm (whisper) is no kernel."""
    from repro_torch.models.transformer import program_for

    grp, n_groups, rem = program_for(cfg)
    out = dict.fromkeys(KERNELS + MESH_KERNELS, 0)
    twice = 2 if train and cfg.remat == "full" else 1
    norms = 2 if cfg.norm == "rmsnorm" else 0
    own = ("flash_attention",) if train else (
        MESH_KERNELS if seq_split else ("decode_attention",))
    for kinds, times in ((grp, twice * n_groups), (rem, 1)):
        for kind in kinds:
            out["rmsnorm"] += norms * times
            if kind != "xattn":
                for name in own:
                    out[name] += times
            if kind in ("xattn", "dec_attn"):
                out["flash_attention" if train else
                    "decode_attention"] += times
    if train and cfg.family == "encdec":
        out["flash_attention"] += twice * cfg.n_encoder_layers
    out["rmsnorm"] += norms // 2
    return out


def _decode_runs_cross():
    return [(arch, dt, "b4", 4, *CROSS_DECODE[arch], True)
            for arch in CROSS_ARCHS for dt in ("float32", "bfloat16")]


def cross4_rank(torch, K, dev, rank: int, out: str) -> dict:
    """``--gloo-program cross4``: one of four ranks of dist_tp_whisper (a
    (2, 2) mesh: whisper's d dims stored over data, heads, MLP and
    vocabulary over model)."""
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(2, 2, device=dev)
    arch = CROSS_ARCHS[0]
    return {arch: _family_tp_runs(torch, K, dev, mesh, arch)}


def cross2_rank(torch, K, dev, rank: int, out: str) -> dict:
    """``--gloo-program cross2``: one of two ranks of dist_tp_llama_vision
    (a (1, 2) mesh) and of dist_decode_whisper / dist_decode_llama_vision
    (on (1, 2), then on (2, 1), held against this process's one-rank runs
    saved in ``out``)."""
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(1, 2, device=dev)
    arch = CROSS_ARCHS[1]
    res = {arch: _family_tp_runs(torch, K, dev, mesh, arch)}
    for shape in CROSS_MESHES:
        res[shape] = _decode_ranks(torch, K, dev, _decode_runs_cross(),
                                   shape, out)
    return res


def dist_cross_phase(torch, K, dev, mesh) -> dict:
    """``dist_tp_whisper``: whisper-large-v3 at full width (2 + 2 of its 32
    + 32 layers), four gloo ranks on a (2, 2) mesh under its rules_for
    storage (FSDP: every d dim over data, ``frontend_proj`` and the
    encoder's final norm too; 10 of 20 heads, 2,560 of 5,120 MLP columns,
    25,933 of 51,866 vocabulary rows a rank over model), B 2 x 448 tokens
    over 1500 frames, the encoder's flash on a rank's 10 heads and the
    cross-attention reading the memory through copy_to_model.
    ``dist_tp_llama_vision``: llama-3.2-vision-11b at full width (5 of its
    40 layers: 4 self-attention layers and one gated cross-attention
    layer, 2.1 B parameters), two gloo ranks on (1, 2) (16 of 32 heads, 4
    of 8 KV heads, 7,168 of 14,336 MLP columns, 64,128 of 128,256
    vocabulary rows), B 1 x S 2048 over 1024 patches.  Both at bf16 and
    at f32 (CROSS_TP), held against this process's runs of the same
    batches on the 1-rank NCCL (1, 1) mesh as ``dist_tp_zamba2`` is.
    ``dist_decode_whisper`` / ``dist_decode_llama_vision``: decode under
    ``serve_rules`` on (1, 2) and (2, 1), B 4, f32 and bf16, DECODE_STEPS
    steps (CROSS_DECODE), each rank's cache its KV block and its batch
    rows of the memory, against this process's one-rank runs as
    ``dist_decode_phase`` holds them.  Returns the launches by path."""
    out = tempfile.mkdtemp(prefix="chip_smoke_cross_")
    failed = []
    try:
        one, g32 = _one_rank_tp(torch, K, dev, mesh, CROSS_ARCHS)
        runs = _decode_runs_cross()
        one_dec = _decode_one_rank(torch, K, dev, runs, out)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        four = _spawn_ranks(torch, "cross4", 4, out)
        four_s = time.perf_counter() - t0
        two = _spawn_ranks(torch, "cross2", 2, out)
        two_s = time.perf_counter() - t0 - four_s
    finally:
        shutil.rmtree(out, ignore_errors=True)
    by_path = {}
    for arch, ranks, shape, seconds in (
            (CROSS_ARCHS[0], four, (2, 2), four_s),
            (CROSS_ARCHS[1], two, (1, 2), two_s)):
        phase = "dist_tp_" + _cross_tag(arch)
        by_path[phase] = _hold_tp_ranks(
            torch, phase, arch, ranks, one[arch], g32[arch], shape, seconds,
            failed, _cross_launches)
    del one, g32
    for arch in CROSS_ARCHS:
        phase = "dist_decode_" + _cross_tag(arch)
        by_path[phase] = _hold_decode_ranks(
            torch, phase, arch, two, runs, one_dec, CROSS_MESHES, two_s,
            failed, _cross_launches)
    check(not failed, "; ".join(failed))
    return by_path


def _cross_tag(arch: str) -> str:
    return {"whisper-large-v3": "whisper",
            "llama-3.2-vision-11b": "llama_vision"}[arch]


# ---------------------------- the multi-pod production layout (2c, 2b)

#: the multi-pod mesh's axes, ``make_production_mesh(multi_pod=True)``'s;
#: the ranks build small meshes of them with the same code
#: (``launch.mesh._mesh``)
POD_AXES = ("pod", "data", "model")
#: dist_multipod runs: tag -> (mesh shape, arch, config changes, bf16
#: train shape, f32 train shape or None).  olmoe-1b-7b at full width, 16
#: -> MULTIPOD_OLMOE_LAYERS layers, on (2, 2, 1) (its experts stored over
#: ("data", "pod"), the a2a path at M 1) and on (2, 1, 2) at S 2047 (M
#: does not divide S: the one-hot path across ranks under grad);
#: whisper-large-v3 at full width, 32 + 32 -> 2 + 2 layers, on (2, 2, 1)
#: (embed, attn_in and attn_out_d over ("data", "pod")), B 4 (the batch
#: splits over pod x data = 4 ranks) x 448 tokens over 1500 frames.  One
#: olmoe layer, not two: each gloo rank gathers a layer's 805 MB of
#: experts through the host three times a step (a one-layer step took 6.6
#: s a rank, PERF.md), and the time limit holds one
MULTIPOD_OLMOE_LAYERS = 1
MULTIPOD_TP = {
    "olmoe_221": ((2, 2, 1), "olmoe-1b-7b", {
        "n_layers": MULTIPOD_OLMOE_LAYERS, "capacity_factor": 3.0},
        (4, 2048), (4, 512)),
    "whisper_221": ((2, 2, 1), "whisper-large-v3",
                    {"n_layers": 2, "n_encoder_layers": 2},
                    (4, WHISPER_TOKENS), None),
    "olmoe_212": ((2, 1, 2), "olmoe-1b-7b", {
        "n_layers": MULTIPOD_OLMOE_LAYERS}, (2, 2047), (2, 511)),
}
#: olmoe's capacity factor on (2, 2, 1), 1.25 -> 3 in training and 8 in
#: decode: there the ranks' a2a shards bucket their own tokens' pairs,
#: the one rank all of them (its a2a at M 1; in decode its one-hot path
#: over B 4 tokens, ceil(32 / 64 x cf) rows an expert), so at 1.25 they
#: drop different pairs and compute different functions, as the
#: reference's layouts do.  At these factors neither can drop one: at M
#: 1 an expert holds T k cf^2 / E rows of T tokens' pairs, at most T of
#: which can choose it, and cf^2 >= E / k = 8 (at 2 the f32 run missed
#: by 0.89 of its largest gradient: PERF.md); decode's one rank holds 4
#: rows an expert for 4 tokens.  On (2, 1, 2) the ranks' one-hot path
#: and the one rank's (MULTIPOD_ONE_HOT) bucket the same global tokens
#: alike, at the config's 1.25
MULTIPOD_DECODE_CF = 8.0
#: the runs whose one-rank reference takes the one-hot path (no mesh,
#: whole moments), as their ranks do
MULTIPOD_ONE_HOT = ("olmoe_212",)
#: the run whose ZeRO-1 state is saved sharded and restored
MULTIPOD_SAVE = ("olmoe_221", "bf16")
#: decode on (2, 2, 1) under serve_rules(multi_pod=True): olmoe-1b-7b
#: with MULTIPOD_OLMOE_LAYERS layers, B 4 (one row a rank), from position
#: 1000 of 2048 keys, MULTIPOD_DECODE_STEPS steps (each gathers every
#: expert through the host: 1.73 s a step at f32, PERF.md), f32 and bf16
MULTIPOD_DECODE_STEPS = 4
MULTIPOD_SEED = 283


def _multipod_cfgs(tag: str):
    """(dtype tag, config, global shape, seed, batches: one a step) of a
    MULTIPOD_TP run: bf16 TP_STEPS steps, f32 one (its hold reads step
    0's gradients; an f32 step gathers 1.6 GB of experts a rank)."""
    from repro_torch.configs import get_config

    _, arch, changes, shape, shape32 = MULTIPOD_TP[tag]
    cfg = get_config(arch).replace(**changes)
    out = [("bf16", cfg, shape, MULTIPOD_SEED, TP_STEPS)]
    if shape32 is not None:
        out.append(("f32", cfg.replace(dtype="float32"), shape32,
                    MULTIPOD_SEED + 2, 1))
    return out


def _decode_runs_multipod():
    arch = f"olmoe-1b-7b:{MULTIPOD_OLMOE_LAYERS}:{MULTIPOD_DECODE_CF}"
    return [(arch, dt, "b4", 4, 2048, 1000, True)
            for dt in ("float32", "bfloat16")]


def _multipod_launches(cfg, train: bool, seq_split: bool = False) -> dict:
    """Each kernel's launches a step of a MULTIPOD run: whisper's as
    ``_cross_launches``; olmoe's a train step with remat="full" each
    layer's flash and four norms forward and in the recompute, the final
    norm once; a decode step each layer's attention and four norms."""
    if cfg.family == "encdec":
        return _cross_launches(cfg, train, seq_split)
    L, twice = cfg.n_layers, 2 if train and cfg.remat == "full" else 1
    out = dict.fromkeys(KERNELS + MESH_KERNELS, 0)
    out["flash_attention" if train else "decode_attention"] = twice * L
    out["rmsnorm"] = twice * 4 * L + 1
    return out


def _multipod_save(torch, cfg, dev, mesh, state, slices, out: str,
                   rank: int) -> dict:
    """The sharded save of a MULTIPOD state with ``shardings=`` under
    ``out/ckpt`` and ``restore_checkpoint(shardings=)`` of it onto the
    same mesh, two ranks at a time (bit-exact local blocks); this rank's
    blocks, with their slices, go to ``out`` for the main process to
    assemble."""
    import gc

    import torch.distributed as dist

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.distributed import activate
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.models.common import local_tree, tree_leaves
    from repro_torch.models.transformer import model_specs
    from repro_torch.train.step import train_state_shardings

    specs = dict(tree_leaves(model_specs(cfg)))
    rec = {}
    with activate(mesh, rules_for(cfg, True)[1]):
        shardings = train_state_shardings(cfg, state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(out, "ckpt"), TP_STEPS, state,
                        shardings=shardings)
        rec["save_s"] = time.perf_counter() - t0
        # two ranks at a time: a local restore lands the whole blob in a
        # page-locked host buffer (6.26 GB, cached by torch's host
        # allocator after), four at once did not fit the host's 96 GiB
        for turn in range(0, dist.get_world_size(), 2):
            if turn <= rank < turn + 2:
                t0 = time.perf_counter()
                back, step = restore_checkpoint(
                    os.path.join(out, "ckpt"), state, device=dev,
                    shardings=shardings)
                torch.cuda.synchronize()
                rec["restore_s"] = time.perf_counter() - t0
                got = dict(tree_leaves(local_tree(back)))
                rec["restored_step"] = step
                rec["restore_bad"] = [k for k, t in tree_leaves(state)
                                      if not torch.equal(got[k], t)]
                del back, got
                gc.collect()
            dist.barrier()
        flat_sh = dict(tree_leaves(shardings))
        blocks = {}
        for k, t in tree_leaves(state):
            pl = flat_sh.get(k)
            leaf = k.split("/", 2)[-1] if k.startswith("opt/") else \
                k[len("params/"):]
            sl = (None if pl is None else slices[leaf]
                  if k.startswith("params/") else pl.mesh.local_slices(
                      pl.spec, specs[leaf].shape))
            blocks[k] = (sl, t.detach().cpu())
        torch.save(blocks, os.path.join(out, f"save_r{rank}.pt"))
    return rec


def multipod_rank(torch, K, dev, rank: int, out: str) -> dict:
    """``--gloo-program multipod``: one of four ranks of dist_multipod.
    It builds the (2, 2, 1) and (2, 1, 2) (pod, data, model) meshes and
    runs every MULTIPOD_TP run on its mesh under the multi-pod rules with
    ZeRO-1 moments (the save of MULTIPOD_SAVE's state among them), the
    MoE runs routed as the one-rank runs were (``routing.pt``), each held
    here against its one-rank run (``ref_TAG_DT.pt``, read mapped:
    ``_hold_tp``), then decode on (2, 2, 1) against this process's
    one-rank runs in ``out``."""
    from repro_torch.launch.mesh import _mesh

    meshes = {shape: _mesh(shape, POD_AXES, dev)
              for shape in dict.fromkeys(v[0] for v in MULTIPOD_TP.values())}
    tables = torch.load(os.path.join(out, "routing.pt"))
    res = {}
    for tag, (shape, *_) in MULTIPOD_TP.items():
        res[tag] = {}
        for dt, c, tshape, seed, steps in _multipod_cfgs(tag):
            routing = (_pinned(torch, tables[f"{tag}/{dt}"])
                       if c.family == "moe" else None)
            state, slices, rec = _sharded_train(
                torch, K, c, dev, meshes[shape], _tp_opt(steps), seed,
                _tp_batches(torch, c, dev, tshape, seed + 1)[:steps],
                multi_pod=True, routing=routing)
            if routing is not None:
                rec["routing_flips"] = routing.n_flips()
            if (tag, dt) == MULTIPOD_SAVE:
                rec["save"] = _multipod_save(torch, c, dev, meshes[shape],
                                             state, slices, out, rank)
            del state
            torch.cuda.empty_cache()
            rec["slices"] = slices
            one = torch.load(os.path.join(out, f"ref_{tag}_{dt}.pt"),
                             mmap=True)
            rec["held"] = _hold_tp(torch, dt, rec, one, one.get("g32"))
            del one, rec["grads0"], rec["slices"]
            res[tag][dt] = rec
            emit("dist_multipod_rank", rank=rank, run=f"{tag} {dt}",
                 ok=rec["held"][0], ms_per_step=rec["ms"],
                 peak_gb=rec["peak_gb"])
    t0 = time.perf_counter()
    res["decode"] = _decode_ranks(torch, K, dev, _decode_runs_multipod(),
                                  (2, 2, 1), out, mesh=meshes[(2, 2, 1)],
                                  multi_pod=True,
                                  steps=MULTIPOD_DECODE_STEPS)
    res["decode_s"] = time.perf_counter() - t0
    return res


def _multipod_one_rank(torch, K, dev, mesh, out: str) -> dict:
    """Every MULTIPOD_TP run on the 1-rank NCCL mesh.  What a rank holds
    its run against goes to ``out/ref_TAG_DT.pt`` (losses, clip norms,
    step 0's gradients; the f32 gradients of a bf16 run's weights, an
    f32 run's floor, as ``_one_rank_tp`` makes them), and the MoE runs'
    routing (``_pinned``) to ``out/routing.pt``, so that this
    process holds no gradients while the ranks run.  Returns each run's
    numbers."""
    one, tables = {}, {}
    for tag in MULTIPOD_TP:
        one[tag] = {}
        for dt, c, shape, seed, steps in _multipod_cfgs(tag):
            batches = _tp_batches(torch, c, dev, shape, seed + 1)[:steps]
            routing = _pinned(torch) if c.family == "moe" else None
            state, slices, rec = _sharded_train(
                torch, K, c, dev, None if tag in MULTIPOD_ONE_HOT else mesh,
                _tp_opt(steps), seed, batches, routing=routing)
            del state
            torch.cuda.empty_cache()
            if routing is not None:
                tables[f"{tag}/{dt}"] = [t.cpu() for t in routing.recorded]
            ref = {k: rec[k] for k in ("losses", "grad_norms", "grads0")}
            if dt == "bf16":
                ref["g32"] = _grads0(torch, c, dev, seed, batches[0])
            else:
                moved = _grads0(torch, c, dev, seed, batches[0], move=1e-7)
                ref["floor"] = max(((k, _dist_from(torch, g, rec["grads0"][
                    k])) for k, g in moved.items()), key=lambda kv: kv[1])
                del moved
            torch.save(ref, os.path.join(out, f"ref_{tag}_{dt}.pt"))
            del ref, rec["grads0"]
            one[tag][dt] = rec
            emit("dist_multipod_one_rank", run=f"{tag} {dt}",
                 losses=rec["losses"], ms_per_step=rec["ms"],
                 peak_gb=rec["peak_gb"])
    torch.save(tables, os.path.join(out, "routing.pt"))
    return one


def _multipod_assemble(torch, cfg, out: str, ranks: int) -> dict:
    """The whole state (flat keys) of ``cfg`` from every rank's
    ``save_rR.pt`` blocks: each block copied into its slices of the
    leaf, the leaves without slices (the steps) taken as they are."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.transformer import model_specs

    specs = dict(tree_leaves(model_specs(cfg)))
    flat = {}
    for r in range(ranks):
        blocks = torch.load(os.path.join(out, f"save_r{r}.pt"), mmap=True,
                            weights_only=False)
        for k, (sl, t) in blocks.items():
            if sl is None:
                flat[k] = t.clone()
                continue
            leaf = k.split("/", 2)[-1] if k.startswith("opt/") else \
                k[len("params/"):]
            flat.setdefault(k, torch.empty(specs[leaf].shape,
                                           dtype=t.dtype))
            flat[k][sl] = t
        del blocks
    return flat


def dist_multipod_phase(torch, K, dev, mesh) -> dict:
    """``dist_multipod_*``: the reference's multi-pod production layout
    (``rules_for(cfg, multi_pod=True)``, ``opt_rules_for(..., True)``) on
    four gloo ranks of one card, one spawn, two (pod, data, model) meshes.
    On (2, 2, 1): olmoe-1b-7b at full width with 1 layer, B 4 x S 2048
    bf16 and B 4 x S 512 f32, experts stored data-major over ("data",
    "pod") and gathered by the a2a path at M 1; whisper-large-v3 at full
    width with 2 + 2 layers, B 4 x 448 tokens over 1500 frames bf16, its
    d dims over ("data", "pod"); ZeRO-1 moments throughout.  The olmoe
    bf16 state is saved sharded, byte-identical to the whole state's save
    here, and restored with ``shardings=`` bit-exact on the ranks; olmoe
    decode (B 4) under
    ``serve_rules(multi_pod=True)``, f32 and bf16.  On (2, 1, 2): olmoe
    at B 2 x S 2047 bf16 and 2 x 511 f32, where M does not divide S, so
    the MoE block trains through the one-hot path across ranks.  Every
    run is held against this process's run of the same weights and
    batches on the 1-rank NCCL (1, 1) mesh as ``dist_tp_zamba2`` is
    (decode as ``dist_decode_phase``), the MoE runs routed as the one
    rank routed (``MoEProbe``'s replay: flips counted), and each rank's
    parameter and moment blocks are the data-major blocks of the spec
    (bytes, shapes).  Returns the launches by path."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.weights import unflatten

    out = tempfile.mkdtemp(prefix="chip_smoke_multipod_")
    failed = []
    t_phase = time.perf_counter()
    try:
        one = _multipod_one_rank(torch, K, dev, mesh, out)
        runs = _decode_runs_multipod()
        one_dec = _decode_one_rank(torch, K, dev, runs, out, pin=True,
                                   steps=MULTIPOD_DECODE_STEPS)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = _spawn_ranks(torch, "multipod", 4, out)
        seconds = time.perf_counter() - t0
        flat = _multipod_assemble(torch, _multipod_cfgs(MULTIPOD_SAVE[0])[
            0 if MULTIPOD_SAVE[1] == "bf16" else 1][1], out, len(ranks))
        t0 = time.perf_counter()
        whole = save_checkpoint(os.path.join(out, "whole"), TP_STEPS,
                                unflatten(flat))
        whole_s = time.perf_counter() - t0
        del flat
        sharded = os.path.join(out, "ckpt", f"step_{TP_STEPS:010d}")
        same = {f: _same_file(os.path.join(whole, f),
                              os.path.join(sharded, f))
                for f in ("data.bin", "manifest.json")}
        nbytes = os.path.getsize(os.path.join(sharded, "data.bin"))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    by_path = {}
    for tag, (shape, arch, *_) in MULTIPOD_TP.items():
        phase = f"dist_multipod_{tag}"
        report, recs = {}, []
        for dt, c, tshape, _, steps in _multipod_cfgs(tag):
            want = {k: steps * n for k, n in _multipod_launches(
                c, True).items() if k in KERNELS}
            for r, res in enumerate(ranks):
                rec = res[tag][dt]
                ok, numbers = rec["held"]
                bad = [name for name, n in want.items()
                       if rec["launches"][name] != n]
                if not rec["blocks_ok"] or rec["moment_bytes"] != \
                        rec["moment_bytes_want"]:
                    bad.append("blocks")
                if not (ok and not bad and rec["device"].startswith(
                        "cuda")):
                    failed.append(f"{phase} {dt}: rank {r} on "
                                  f"{rec['device']}, {bad} off "
                                  f"({rec['launches']} vs {want}): "
                                  f"{numbers}")
                report.setdefault(dt, []).append({
                    "ok": ok, "losses": rec["losses"],
                    "ms_per_step": rec["ms"], "peak_gb": rec["peak_gb"],
                    "moment_gb": rec["moment_bytes"] / 1e9,
                    "blocks_data_major": rec["blocks_ok"],
                    "routing_flips": rec.get("routing_flips"),
                    "launches": rec["launches"], **numbers,
                    **({"save": rec["save"]} if "save" in rec else {})})
                recs.append(rec)
            mine = one[tag][dt]
            report[f"{dt}_one_rank"] = {
                "losses": mine["losses"], "ms_per_step": mine["ms"],
                "peak_gb": mine["peak_gb"],
                "moment_gb": mine["moment_bytes"] / 1e9,
                "n_layers": c.n_layers, "batch": tshape[0],
                "seq": tshape[1], "steps": steps}
        emit(phase, arch=arch, mesh=list(shape), axes=list(POD_AXES),
             rules="rules_for(multi_pod=True), opt_rules_for(True)",
             steps=TP_STEPS, backend="gloo (through the host, 4 ranks on "
             "one card, not NVLink)", one_rank_backend="nccl (1, 1)",
             loss_rtol=TP_LOSS_RTOL, f32_tol=TP_F32_TOL,
             bf16_factor=TP_BF16_FACTOR, spawn_s=seconds, **report)
        by_path[phase] = _sum_launches(recs)
    tag, dt = MULTIPOD_SAVE
    saves = [res[tag][dt]["save"] for res in ranks]
    for r, sv in enumerate(saves):
        if sv["restored_step"] != TP_STEPS or sv["restore_bad"]:
            failed.append(f"dist_multipod_save: rank {r} restored step "
                          f"{sv['restored_step']}, not bit-exact: "
                          f"{sv['restore_bad'][:5]}")
    if not all(same.values()):
        failed.append(f"dist_multipod_save: the sharded save differs from "
                      f"the whole save: {same}")
    emit("dist_multipod_save", run=f"{tag} {dt}", byte_identical=same,
         sharded_save_bytes=nbytes, whole_save_s=whole_s,
         ranks=[{k: sv[k] for k in ("save_s", "restore_s")}
                for sv in saves])
    by_path["dist_multipod_decode"] = _hold_decode_ranks(
        torch, "dist_multipod_decode", runs[0][0], [
            {(2, 2, 1): res["decode"]} for res in ranks], runs, one_dec,
        ((2, 2, 1),), seconds, failed, _multipod_launches,
        axes=POD_AXES, multi_pod=True, steps=MULTIPOD_DECODE_STEPS)
    emit("dist_multipod", seconds=time.perf_counter() - t_phase,
         spawn_s=seconds, decode_s=[res["decode_s"] for res in ranks])
    check(not failed, "; ".join(failed))
    return by_path


#: --gloo-program -> (world size, the rank's function)
GLOO_PROGRAMS = {"moe": (2, moe_rank), "tp": (2, tp_rank),
                 "zero1": (4, zero1_rank),
                 "decode_qwen3": (4, decode_qwen3_rank),
                 "decode_pair": (2, decode_pair_rank),
                 "recurrent": (2, recurrent_rank),
                 "cross4": (4, cross4_rank), "cross2": (2, cross2_rank),
                 "multipod": (4, multipod_rank)}


def distributed_phase(torch, K, dev) -> dict:
    """The distributed phase's parts b-d and the two gloo ranks under one
    1-rank NCCL group and a (1, 1) mesh (part a runs inside the restore
    phase, while its checkpoint is on disk)."""
    by_path = {}
    with dist_group(torch, dev) as mesh:
        by_path["dist_qwen3_dp"] = dist_qwen3_phase(torch, K, dev, mesh)
        by_path.update(dist_olmoe_phase(torch, K, dev, mesh))
        by_path["dist_compression"] = dist_compression_phase(torch, K, dev,
                                                             mesh)
        dist_gloo_phase(torch, dev, mesh)
        by_path["dist_tp_qwen3"] = dist_tp_phase(torch, K, dev, mesh)
        by_path["dist_zero1_save"] = dist_zero1_phase(torch, K, dev, mesh)
        by_path.update(dist_decode_phase(torch, K, dev, mesh))
        by_path.update(dist_recurrent_phase(torch, K, dev, mesh))
        by_path.update(dist_cross_phase(torch, K, dev, mesh))
        by_path.update(dist_multipod_phase(torch, K, dev, mesh))
    return by_path



def rmsnorm_only(torch, K, dev, build_) -> int:
    """``--rmsnorm-only``: build, then only rmsnorm's ``kernel_time`` lines
    at RMSNORM_TIME_SHAPES, for the checkout whose ``src`` was given; run
    once per checkout in one call, in turns, to compare two trees' kernels
    on one card."""
    b = build_()
    emit("build", src=K.__file__, cached=b.cached)
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(
            getattr(torch, dt))

    for rows, d in RMSNORM_TIME_SHAPES:
        rmsnorm_time(torch, K, dev, randn, b.ptxas, rows, d)
    print(nvidia_smi(), flush=True)
    return 0


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rmsnorm-only", action="store_true",
                    help="time only rmsnorm (for comparing two checkouts)")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch is driven")
    ap.add_argument("--gloo-rank", type=int, default=None,
                    help=argparse.SUPPRESS)     # the distributed phase's
    ap.add_argument("--gloo-dir", default=None,  # own rank processes
                    help=argparse.SUPPRESS)
    ap.add_argument("--gloo-program", default="moe",
                    choices=tuple(GLOO_PROGRAMS), help=argparse.SUPPRESS)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no repro_torch under {src}; run it from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    # the bytecode of torch and of what it imports later (the modules of
    # the first checkpointed training step) written under build/ by the
    # first process and read by every gloo rank process, which would
    # otherwise compile it again where the machine writes no bytecode
    # (PYTHONDONTWRITEBYTECODE; a rank's first step took 15-24 s there)
    sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
    sys.dont_write_bytecode = False
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)

    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels._build import build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.gloo_rank is not None:
        return gloo_rank(torch, K, args.gloo_rank, args.gloo_dir,
                         args.gloo_program)
    if args.rmsnorm_only:
        return rmsnorm_only(torch, K, dev, build)
    smi = nvidia_smi()
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), python=sys.version.split()[0])
    try:
        t0 = time.perf_counter()
        b = build()
        emit("build", seconds=time.perf_counter() - t0, cached=b.cached,
             library=os.path.relpath(b.path, ROOT), ptxas=list(b.ptxas))

        summary = kernel_phase(torch, K, dev, b.ptxas)
        summary.append(decode_partials_phase(torch, K, dev, b.ptxas))
        geometry_phase(torch, dev)

        cfg = get_config("qwen3-1.7b")
        params = restore_phase(torch, cfg, dev)
        serve_launches, params, toks, _ = serve_phase(torch, K, cfg, dev,
                                                      params)
        by_path = {"serve": serve_launches,
                   "prefill": prefill_phase(torch, K, cfg, dev, params)}
        by_path["compute_probs"] = compute_probs_phase(torch, K, cfg, dev,
                                                       params)
        by_path["train_grad_hold"] = train_grad_phase(torch, K, dev)
        # trains the restored weights in place; nothing reads them after
        by_path["train"] = train_phase(torch, K, cfg, dev, params)
        by_path["train_resume"] = train_resume_phase(torch, K, cfg, dev)
        del params
        torch.cuda.empty_cache()
        by_path["examples"] = examples_phase(torch, K, dev)
        by_path.update(distributed_phase(torch, K, dev))
        by_path["hybrid_prefill"], by_path["hybrid_generate"] = \
            hybrid_phase(torch, K, dev)
        by_path.update(gemma3_phase(torch, K, dev))
        for arch in ("qwen2.5-14b", "nemotron-4-15b"):
            by_path.update(dense_large_phase(torch, K, dev, arch))
        by_path.update(xlstm_phase(torch, K, dev))
        by_path.update(moe_phase(torch, K, dev))
        by_path.update(kimi_phase(torch, K, dev))
        for arch in ("whisper-large-v3", "llama-3.2-vision-11b"):
            by_path.update(cross_family_phase(torch, K, dev, arch))
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for entry in summary:
        name = entry["name"]
        entry["launches_by_path"] = {p: n.get(name, 0)
                                     for p, n in by_path.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if name == "decode_attention_partials":     # and its merge launches
            entry["merge_launches"] = sum(
                n.get("decode_attention_merge", 0) for n in by_path.values())
        if entry["launches"] == 0 or entry.get("merge_launches") == 0:
            print(f"chip_smoke: FAILED: {name} never launched on the main "
                  f"paths", file=sys.stderr)
            return 1
    print(json.dumps({"kernels": summary}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
