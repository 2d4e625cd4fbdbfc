#!/usr/bin/env python3
"""Proof that the PyTorch port (``src/repro_torch``) runs on one NVIDIA Hopper
card, and the numbers of its kernels there.

    python3 chip_smoke.py
    python3 chip_smoke.py --ssd-only [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --flash-bwd-only
    python3 chip_smoke.py --moe-bwd-only [--src OTHER_CHECKOUT/src]
    python3 chip_smoke.py --ep-only
    python3 chip_smoke.py --tp-only
    python3 chip_smoke.py --fsdp-only
    python3 chip_smoke.py --seq-only
    python3 chip_smoke.py --dryrun-only
    python3 chip_smoke.py --cp-only
    python3 chip_smoke.py --mamba-tp-only
    python3 chip_smoke.py --wow-only
    python3 chip_smoke.py --sim-only

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. info: card name and power limit, torch and CUDA versions; TF32 off.
2. build: every CUDA kernel from the sources in the checkout, in parallel;
   ptxas's registers and spills by instantiation, and none allowed in the
   wgmma bodies of flash's backward and of the grouped FFN's backward
   (whose products ptxas must not serialize either: no C7520 note) nor in
   any of the SSD backward's eleven instantiations.
3. kernels vs their plain PyTorch versions on the card, at the cases of
   tests/test_kernels.py and at the very shapes that phase 5 serves (flash
   attention: hd-128 prefill shapes, the served prompts of deepseek-7b,
   llama4-scout and zamba2-2.7b (hd 80), whisper-medium's decoder and
   llava-next's 2880 patches + prompt, bf16 cases for every branch of the
   wgmma kernel at hd 64 and 128, f32 and bf16 cases at hd 80, and
   whisper's non-causal attentions at hd 64 and 128 (its encoder over 1500
   frames, its cross-attention with T > S, T ragged, and T < S); the
   grouped expert FFN: llama4-scout's prefill of each served prompt and its
   decode step, a 768-token prefill, arctic's expert widths, and buffers
   with dead experts and dead rows as the MoE dispatch leaves them, whose
   outputs must be exact zeros; the SSD intra-chunk kernel: mamba2-780m's
   and zamba2-2.7b's prefill of each served prompt, mamba2's of 1- and
   2-token prompts, x in bf16, each one-chunk prompt (ragged L) again under
   mild decay, B > 1, x as a view of the model's projection, inputs not
   16-byte aligned and P < 64; for flash and SSD, an f64 sum as the
   yardstick of rounding, which flash's bf16 rows may be no farther from
   than the plain version's).  Then the flash backward and the forward's
   row logsumexp against their plain versions (the backward in f32 from the
   same bf16 inputs), called as training calls them, through
   ``flash_attention``'s autograd Function (o, the saved lse, dq, dk, dv,
   one backward call counted each): tests/test_kernels.py's flash cases,
   deepseek-7b's training shape (2, 2048, 32, 128), GQA with a window of
   256, a kv prefix (T > S), hd 80, f32 at the smoke configs' hd 16, one
   partial tile, GQA at hd 64 with a window over several tiles,
   granite-34b's MQA (48:1) at hd 128, llama4-scout's training shape
   (GQA 5:1), and whisper's non-causal cases on the wgmma body and in f32
   at hd 64; with an f64 sum at two shapes as the yardstick of rounding;
   and a second call at the training shape, the windowed GQA cases and
   whisper's encoder, which must give bit-identical dq, dk, dv.  The
   grouped FFN's backward through ``GroupedFFN`` against its plain version in f32 (llama4-scout's
   training shape, arctic's expert widths, dead experts and rows as the
   dispatch leaves them, gelu with zero X rows under nonzero dY rows,
   ragged D and F, f32 at the smoke widths, B = 3 with C = 100, gelu on
   full tiles): dead rows' dX and dead experts' weight gradients exact
   zeros, a second call at the training shape bit-identical.  The SSD
   backward through ``SSDIntraChunk`` against its plain version in f32
   (mamba2-780m's and zamba2-2.7b's training shapes with x bf16, mamba2's
   with x f32 and under mild decay, the model's strided views, one-chunk
   prompts of ragged L and L = 1, unaligned inputs (x f32 and x bf16),
   P 36 and N 20, the tests' and the smoke configs' shapes in f32, losses
   that read y only or the states only, and L one past a 64-row tile): a
   second call at the training shapes bit-identical, and an f64 sum as the
   yardstick of rounding.  Then the two backwards' device times by launch
   (the SSD one at both training shapes), profiled before the long
   phases.
4. the port on the card vs the same port code on the CPU (f32 smoke
   configs of deepseek-7b, gemma3-27b, arctic-480b, llama4-scout,
   mamba2-780m and zamba2-2.7b through the engine; whisper-medium and
   llava-next through prefill and 8 decode steps): greedy tokens equal,
   logits within rel 5e-4.  Training, from one initial state (f32 smoke
   deepseek-7b, phi4-mini-3.8b (GQA), gemma3-27b (window), llama4-scout and
   arctic-480b (MoE, the grouped FFN's backward kernel), mamba2-780m and
   zamba2-2.7b (the SSD backward kernel), whisper-medium (frames; flash
   non-causal in its encoder and cross-attention) and llava-next
   (patches)): the step-1 gradients leaf by leaf within 1e-4 with one
   backward call a layer of each kernel, 3 steps' losses (the trainer's;
   whisper's and llava's through ``make_train_step``) within rel 1e-4, and
   the card's checkpoint restored on the CPU.  And deepseek-7b at
   full width cut to 2 layers, bf16 against f32 on the card from one state
   at the training shape: the step-1 loss and gradients and 3 steps'
   losses (the bf16 kernels through the model, the f32 ones as yardstick).
5. the six main paths, with random weights from a seed and every kernel
   launch counted from 0.  Served by ``ServingEngine``: full-width
   deepseek-7b (bf16), llama4-scout at its full widths with 12 of its 48
   layers (bf16, 57 GB of weights; all 48 do not fit one card),
   mamba2-780m and zamba2-2.7b at their full width and depth (bf16).
   Served by the batched loop of ``launch/serve.py`` (their prefill takes
   frames or patches besides tokens): whisper-medium (72 flash launches a
   prefill: 24 encoder, 24 decoder, 24 cross; and one prefill's peak memory
   with the non-causal attentions on the kernel and on the plain version)
   and llava-next-mistral-7b at full width and depth (bf16).
5b. the training path: ``Trainer`` on deepseek-7b at its full width and
   depth (30 layers, bf16, remat "full", AdamW with bf16 moments), 6 steps
   of 2 x 2048 tokens, every launch counted from 0 (60 flash forwards and
   30 backwards a step); ms per step, tokens/s, losses, grad norms, peak
   memory, a profiled step (by kind: matrix products, flash forward and
   backward, the rest), and AdamW's update alone.
5c. the MoE training path: the same on llama4-scout at its full widths,
   cut to 2 of its 48 layers (6.47 G parameters), every launch counted
   from 0 (a step: 4 grouped-FFN forwards, 2 backwards, 4 flash forwards,
   2 backwards), every backward on the wgmma body; its profiled step also
   splits out the grouped FFN's forward and backward.
5d, 5e. the SSM and hybrid training paths: the same on mamba2-780m (48
   mamba layers; a step: 96 SSD forwards, 48 backwards) and zamba2-2.7b (54
   mamba layers and the shared attention block after every 6: 108 SSD
   forwards, 54 backwards, 18 flash forwards at hd 80, 9 backwards) at
   their full width and depth; their profiled steps split out the SSD
   forward and backward.
5f, 5g. the encoder-decoder and the VLM trained through
   ``launch/steps.make_train_step`` and AdamW (bf16 moments; ``Trainer``'s
   loader makes tokens only), at full width and depth, 6 steps:
   whisper-medium at 8 x (1500 frames + 448 decoder tokens), a step 144
   flash forwards and 72 backwards; llava-next at 2 x (2880 patches + 1216
   tokens), 64 and 32; ms per step, label tokens/s (and llava's
   positions/s), peak memory, a profiled step, AdamW alone.
6. kernel timing with CUDA events beside the plain version, a PyTorch
   yardstick, and the card's bound for the same work (flash attention at
   (1, 2048, 32, 128), at deepseek's longest served prefill, at zamba2's
   (hd 80) and non-causal at whisper's encoder (8, 1500, 16, 64); the
   grouped FFN at decode with the served occupancy
   of 4 live experts, at decode with every row filled, and at the longest
   served prompt's prefill, each bound over the bytes of the live
   experts; the SSD kernel at mamba2's
   longest served prefill and at its one-chunk prompts of 254 and 92
   tokens; the flash backward's wgmma body at the training shape and at
   phi4-mini's GQA (2, 2048, 24, 8, 128), each beside the mma.sync body
   (asked for by name) and autograd's backward of SDPA, and non-causal at
   whisper's encoder beside SDPA's backward; the grouped FFN's
   backward (with each pass's device time) and forward at llama4-scout's
   training shape with every row live, beside autograd's backward of the
   bmm yardstick and the yardstick; the SSD backward at mamba2-780m's and
   zamba2-2.7b's training shapes (with each launch's device time, and the
   bf16 products it issues beside the function's work) beside autograd's
   backward of the f32 bmm spelling of the plain forward;
   each in three rounds taken in turns with its yardstick, the card's
   clocks read before and after).  The bounds' work comes from
   ``repro_torch/roofline/kernel_model.py``, the peaks from
   ``repro_torch/roofline/model.py`` (the H100 SXM's data sheet).
7. roofline: (a) each of the twelve main paths dry-run on meta
   (``launch/dryrun.py``) at its exact config, batch, layers and moments
   (the engine's prefills one a served prompt, its decode step at the
   slots and max_len it serves), beside phase 5's measured times and peak:
   counted FLOPs and bytes by kind, the bound at the data-sheet peaks,
   MODEL_FLOPS, and mfu = model_flops / (measured s x 989e12), bound_share
   = bound / measured, peak_ratio = dry-run peak / max_memory_allocated;
   (b) one more training step of deepseek-7b, llama4-scout (2 layers) and
   mamba2-780m counted on the card (phase 5b-5d), equal kind by kind, in
   integer FLOPs and bytes, to the meta count of the same step, with one
   kernel call for each launch of a step; (c) the scheduler's winner twin
   (``repro_torch.core.torch_winner``) on the card against a numpy staged
   reduction over 1200 draws, bit-identical, and one call at n 4096 timed
   beside numpy's.
8. expert parallelism: llama4-scout at its full widths cut to 2 of its 48
   layers (as 5c), bf16, the MoE layer's forward and backward on 2 x 2048
   tokens and 3 ``make_train_step`` steps from the seed-0 state: first the
   dense dispatch of one process, then each sharding mode ("tp", the
   all-reduce path; "fsdp", the all-to-all path) on a (1, 1) mesh over
   NCCL, held bit for bit to the dense dispatch (y, aux, the layer's
   gradients, every step-1 gradient leaf, the losses), the grouped FFN's
   kernels counted (13 forwards, 7 backwards a variant) and the path's
   calls counted; ms per step beside 5c's and the NCCL kernels' device
   time a layer from a profiled step.  With 2 or more cards it also runs
   each mode on a (1, world) mesh, one spawned process a card (at most
   4), each rank held to the dense dispatch within bf16 bounds; on one
   card it says that this part ran at world 1 only.
9. tensor parallelism ("tp" mode: every leaf the rules split over "model"
   held and computed on as the rank's slice) at deepseek-7b's published
   widths (32 heads x 128, d_ff 11008, vocab 102400, bf16): (a) on a (1, 1)
   mesh over NCCL, 3 ``make_train_step`` steps of 2 of its 30 layers on 2 x
   2048 tokens from one state, bit for bit those without a mesh (every
   step-1 gradient leaf, the losses and grad norms: at one rank the
   tensor-parallel path runs one process's arithmetic); phase 5's
   deepseek requests served at full depth on the mesh, greedy tokens equal
   to phase 5's; the trained state checkpointed on the mesh (whole leaves)
   and restored into a fresh model bit for bit; ms per step beside the
   unsharded step's and NCCL's device time from a profiled step.  (b) One
   full-width layer's attention (flash at 16 and 8 heads) and MLP (5504 and
   2752 columns) as each rank of "model" at 2 and 4 ranks holds them
   (``shard_params`` at each coordinate), forward and backward without
   "f" and "g": the ranks' outputs and dx summed in rank order and their
   weight gradients concatenated, held to the whole layer within bf16
   bounds; flash timed at 32, 16 and 8 heads.  The path's flash launches
   join the kernel line's totals.
10. fsdp (ZeRO-3: every leaf the rank's part over the whole mesh, each
   layer gathered whole inside its remat unit, its gradients
   reduce-scattered) and ZeRO-1 (the AdamW moments' parts over "data") at
   deepseek-7b's published widths, bf16: (a) on a (1, 1) mesh over NCCL, 3
   ``make_train_step`` steps of 2 of its 30 layers on 2 x 2048 tokens in
   "fsdp" and in "tp" with ZeRO-1 moments, each bit for bit those without
   a mesh (every step-1 gradient leaf, the losses and grad norms); phase
   5's deepseek requests served at full depth in "fsdp", greedy tokens
   equal to phase 5's; the trained fsdp state checkpointed and restored
   into a fresh model bit for bit; ms per step, peak memory, NCCL's
   device time from a profiled step, decode ms per step.  (b) In one
   process, at 2 and 4 ranks: each leaf's ranks' fsdp parts concatenated
   in rank order equal to the whole leaf; each rank's rows of a 4 x 2048
   batch forward and backward, the ranks' gradients summed in rank order
   over n held to the whole batch's within bf16 bounds; each data rank's
   ZeRO-1 part of one AdamW update concatenated in rank order equal to the
   whole update bit for bit; the GB of state a rank holds at 30 layers,
   from the local shapes.  The path's flash launches join the kernel
   line's totals.
11. the sequence split of an "fsdp" batch smaller than the mesh (each
   rank one contiguous slice of its rows' sequence), in one process (at
   world 1 every batch divides the mesh, and NCCL puts no two ranks on
   one card): layer 0 of deepseek-7b (32 heads x 128, d_ff 11008) and of
   mamba2-780m (48 heads x 64, state 128, chunk 256) at their published
   widths, bf16, on 1 x 4096 tokens, whole and as each of 2 and 4
   sequence ranks holds it, through the port's own layer code with the
   sequence's collectives done among the ranks in turn (``SeqRanks``:
   forward in rank order, backward in reverse, each gather's gradient
   summed into the rank that sent it): each rank's attention against the
   keys of the ranks up to its own (flash at S = 4096 / n against T = (r +
   1) S), its mamba layer from the conv halo and the state the earlier
   ranks leave.  The ranks' y and dx concatenated in rank order, their
   weight gradients summed in rank order and (deepseek) the keys' and
   values' gradients each rank's backward got, held to the whole layer
   within bf16 bounds; no gradient reaches a later rank.  The positions
   are the port's (``lm.seq_positions``).  Then ``lm.prefill`` of the
   one-layer model on 1 x 4096 tokens as each rank holds them, the ranks
   run twice in rank order without autograd: each rank's last logits and
   cache (k/v of the whole prompt, the mamba conv tail and state at its
   end, pos its length; ``lm.forward``'s positions, ``seq_last`` and the
   mamba prefill cache) held to the whole prompt's within bf16 bounds, pos
   exactly.  Then flash's
   forward and backward timed at each rank's (S, T), the SSD kernel at
   each rank's chunks, and the state pass alone.  Then the families with
   a second layout, the ranks in threads of this process that take turns
   at each collective (``SeqThreads``: the collectives torch ops on the
   ranks' parts, so that one backward runs every rank's): llama4-scout's
   MoE layer 0 on 1 x 4096 tokens (each rank routes its slice, the
   all-to-all hands each rank its 16 / n experts' slots; at E / k, where
   nothing drops, y, dx, aux and the gradients against the whole layer;
   at its own 1.25 each rank's y against the dense dispatch of its slice
   alone); whisper-medium's encoder and decoder layers on 1500 frames +
   448 tokens and the prefill of a one-plus-one-layer model, its frames
   split as the tokens and whole beside them; llava-next's one-layer
   train_loss (the patches and tokens joined and cut into each rank's
   slice, the text CE over each rank's text positions) on 2880 patches +
   1216 tokens and its prefill, and the same on 2878 patches lying whole
   on each of 4 ranks beside the split tokens (4094 positions, the tail
   padded to 4 x 1024; flash at each rank's (1024, (r+1) 1024)): each
   against the whole within bf16 bounds, each family's seconds printed;
   then flash and the grouped FFN timed at those ranks' shapes.
   The path's flash, grouped-FFN and SSD launches join the kernel line's
   totals.

12. the mesh dry run (``launch/dryrun.py --multi-pod``): (a) the
   reference's own cells counted as the last rank of its production meshes
   holds them, each in a process of its own (a world of the "fake" backend
   must be its process's only group), all started together: deepseek-7b's
   train_4k, prefill_32k and decode_32k on (16, 16) and (2, 16, 16) in
   "tp" and "fsdp", llama4-scout's train_4k in "fsdp" (the all-to-all),
   mamba2-780m's prefill_32k in "fsdp" (the state pass over a split
   sequence) and whisper-medium's train_4k on (2, 16, 16) in "fsdp" (whole
   frames beside split tokens); every cell must be ok, and its terms,
   collective link bytes by kind and axis, peak and fit are printed (data-
   sheet estimates, no measurement).  (b) On the card, a (1, 1) NCCL mesh:
   one training step of deepseek-7b's 2 layers in "fsdp" and in "tp" with
   ZeRO-1, and of llama4-scout's 2 layers in "fsdp", each counted on the
   card, list the same collective calls by kind and axis as the same step
   counted on meta over a fake world of one (in a process of its own);
   ``make_serve_step`` on the mesh, in both modes, with the whole tokens
   and the rank's part of the cache, gives deepseek-7b's greedy tokens and
   cache bit for bit against no mesh.  The path's launches join the kernel
   line's totals.  (a) also counts gemma3-27b's long_500k on (16, 16) in
   both modes.
13. context-parallel decode and fsdp's kv heads (the decode cache as the
   reference's ``cache_shardings`` lays it), the ranks of one axis as
   threads of this process (``CpThreads``): (a) gemma3-27b at its
   published widths cut to 6 of 62 layers (5 windowed, 1 global), a bf16
   cache of T = 524288 positions from a seed, pos near its end: 4 decode
   steps on the whole cache, then each layer fed the same input on 16
   ranks' positions (T/16 each; every rank but the last holds no position
   of the windowed layers): y within bf16 bounds of the whole, the written
   rows bit for bit on the owning rank only; then the chain through
   ``make_serve_step`` on the threads' (16, 1) mesh in "tp" and in "fsdp",
   each rank's cache ``Model.cache_part``'s of the whole one (the step
   installs the positions' split): logits within bf16 bounds, every rank
   alike; times of the whole step, one rank's partial and the combine.
   (b) zamba2-2.7b's shared attention block (hd 80, 32 kv heads) at T =
   524288 over 16 ranks.  (c) deepseek-7b's decode_32k rank (8 rows,
   32768 positions) with its 32 kv heads over 16 ranks of "model", y
   summed in rank order.  (d) a batch of one on a (1, 1) NCCL mesh,
   ``make_serve_step`` in both modes, tokens and cache bit for bit against
   no mesh (one rank divides the batch: nothing is split there).

14. mamba's projections split over "model" ("tp": each rank runs the mamba
   block on its own heads from the rules' slices of ``in_proj``,
   ``conv_w``, ``conv_b`` and ``out_proj``, which the column exchange cuts
   into the columns its heads read; the conv and ssm decode states over
   "model" as ``cache_shardings`` lays them, in both modes): (a) on a (1, 1)
   NCCL mesh, where every split counts, 3 ``make_train_step`` steps of
   mamba2-780m at full width and depth from one state, bit for bit those
   without a mesh (every step-1 gradient leaf, the losses, the grad
   norms), ms per step beside the unsharded step's; phase 5's mamba2
   requests served on the mesh, greedy tokens equal to phase 5's.  (b)
   The ranks of "model" as threads of this process (``MambaThreads``, on
   ``CpThreads``): layer 0 of mamba2-780m at published widths, bf16, 1 x
   4096 tokens, as each of 2, 4 and 16 ranks holds it (``shard_params`` at
   each coordinate), forward and backward, the SSD kernels at 24, 12 and 3
   heads; zamba2-2.7b's at 16 ranks (5 heads): y summed over the ranks,
   dx and every leaf's gradient within bf16 bounds of the whole layer's.
   (c) mamba2-780m at full depth on long_500k's rank, a batch of one: a
   prefill, then 4 ``make_serve_step`` steps on 16 ranks of "model" as
   threads in "tp" and "fsdp", each rank's cache ``Model.cache_part``'s:
   logits every rank alike and within bf16 bounds of no mesh, each rank's
   conv and ssm parts those of the whole cache.  Then the SSD forward and
   backward timed at the ranks' head counts, and one layer's decode:
   whole, the last of 16 ranks' share, and its collectives alone (as
   local stand-ins: the machine has one card).  Phase 12's cells gain
   mamba2-780m's and zamba2-2.7b's long_500k on (16, 16) in "tp".

15. WOW's scheduler core (``repro_torch.core``; no kernel: the blocked
   drain runs as torch ops) at ``device="cuda"`` held against itself at
   ``device="cpu"``, decision for decision: (a) the batched-drain scenario
   of ``benchmarks/scheduler_scale.py`` at 1024 nodes and 4096 ready
   fan-in tasks, a cold round and 3 waves, flat and on the ``site``
   topology (racks of 32, 4 a site, oversubscription 8): every round's
   action stream equal, ms per ``schedule()`` and the step-1 and step-2/3
   seconds on each device; (b) the mock RM driving ``make_adapter("wow",
   ...)`` through a seeded fan-in DAG over 64 nodes with declines
   (``decline_prob`` 0.3), on the virtual clock: the report and the action
   stream equal on both devices.
16. WOW's simulator (``repro_torch.sim`` with ``repro_torch.workloads``; no
   kernel: the flow network's dense fill runs as torch ops) at
   ``device="cuda"`` held against itself at ``device="cpu"``: equal
   ``SimResult``s (``dataclasses.asdict``) and ``action_log``s, nothing
   caught.  (a) the paper's evaluation: every registry workflow under wow
   on the default cluster (8 nodes, Ceph), at ``benchmarks/common.py``'s
   scales, the ML pipelines at 1.0: makespans in simulated seconds, wall
   seconds on each device; (b) ``benchmarks/scheduler_scale.py``'s
   ``sim_throughput`` case, group on 1024 nodes at scale 10.24: wow flat,
   wow and orig on the ``site`` topology (racks of 32, 4 a site,
   oversubscription 8, core 2), orig's welded flows taking the dense fill
   on the card (its count must be above 0): wall seconds and events per
   second; (c) group with a node failure and a join under orig, cws and
   wow, and a seeded open-loop stream of two tenants, one retrying, through
   ``run_traffic`` under wow: ``TrafficResult``s equal too.

``--ep-only`` runs phase 8 alone, ``--tp-only`` phase 9, ``--fsdp-only``
phase 10 (serving phase 5's deepseek requests without a mesh itself, for
the tokens to hold), ``--seq-only`` phase 11, ``--dryrun-only`` phase 12,
``--cp-only`` phase 13, ``--mamba-tp-only`` phase 14 (serving phase 5's
mamba2 requests without a mesh itself), ``--wow-only`` phase 15,
``--sim-only`` phase 16.
``--flash-bwd-only`` builds the flash kernels, prints the wgmma backward's
registers and spills (none allowed),
and runs the backward's part of phases 3 and 6 alone; ``--moe-bwd-only``
does the same for the grouped FFN's backward.  ``--ssd-only`` runs phases
1 and 2 and the SSD kernels' part of phases 3 and 6 alone, the backward's
too, and prints a sha256 of the forward's outputs at fixed inputs (to hold
a change against the parent's bits).  With ``--src``, these two take
``repro_torch`` from another checkout (a ``git archive`` of the parent
commit, say), to check and time two versions of a kernel in one call on
one card; another checkout's build is reported but not held to this
one's register rules.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  The whole record also goes to
``chiprun_out/chip_smoke.json``.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM's data-sheet peaks and each kernel's work, from the port
# (fails, and the script exits non-zero, outside a checkout of the repo)
from repro_torch.roofline import kernel_model  # noqa: E402
from repro_torch.roofline.model import HBM_BW as PEAK_BYTES  # noqa: E402
from repro_torch.roofline.model import PEAK_F32_FLOPS  # noqa: E402
from repro_torch.roofline.model import PEAK_FLOPS as PEAK_BF16_FLOPS  # noqa

LLAMA4 = "llama4-scout-17b-a16e"
LLAMA4_LAYERS = 12            # of 48: 57 GB of bf16 weights on an 80 GB card
MAMBA2 = "mamba2-780m"        # all 48 layers: 1.56 GB of bf16 weights
ZAMBA2 = "zamba2-2.7b"        # all 54 layers: 5.4 GB of bf16 weights
WHISPER = "whisper-medium"    # 24 + 24 layers, 1500 frames
LLAVA = "llava-next-mistral-7b"   # 32 layers, 2880 patches: 14.5 GB

# tests/test_kernels.py:20-28 -- B, Sq, Skv, H, K, hd, causal, window
FLASH_CASES = [
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 100, 100, 4, 4, 64, True, 0),
    (2, 32, 128, 4, 1, 16, True, 0),
    (1, 128, 128, 8, 2, 64, True, 24),
    (1, 96, 96, 2, 2, 32, False, 0),
    (1, 64, 64, 2, 2, 128, True, 0),
]
# hd-128 prefill shapes at deepseek-7b's width (bf16): B, S, H, K, hd,
# window; the last adds GQA (K=8) and a sliding window of 256
PREFILL_CASES = [(1, 512, 32, 32, 128, 0), (1, 2048, 32, 32, 128, 0),
                 (2, 1024, 32, 8, 128, 256)]
TIMED = (1, 2048, 32, 32, 128, 0)
# bf16 cases for every branch of the wgmma kernel (hd 64 and 128): S not a
# multiple of the 128-row tile, a kv prefix (T > S), GQA with a window of
# 256, a single partial tile, and no causal mask
WGMMA_CASES = [(b, s, t, h, k, hd, c, w) for hd in (64, 128)
               for b, s, t, h, k, c, w in [
                   (1, 100, 100, 4, 4, True, 0), (1, 663, 663, 8, 8, True, 0),
                   (2, 32, 128, 4, 1, True, 0), (1, 700, 700, 8, 2, True, 256),
                   (1, 64, 64, 4, 2, True, 0), (1, 200, 200, 2, 2, False, 0)]]
# hd 80 (zamba2; the mma.sync body in bf16, FMAs in f32), in both dtypes:
# S not a multiple of 64, a kv prefix (T > S) with MQA, GQA with a window
# of 256, one partial tile, no causal mask, and 663 rows
HD80_CASES = [(b, s, t, h, k, 80, c, w) for b, s, t, h, k, c, w in [
    (1, 100, 100, 4, 4, True, 0), (2, 32, 128, 4, 1, True, 0),
    (1, 700, 700, 8, 2, True, 256), (1, 64, 64, 4, 2, True, 0),
    (1, 200, 200, 2, 2, False, 0), (1, 663, 663, 8, 8, True, 0)]]
# whisper's non-causal attentions (its encoder and its cross-attention) on
# the wgmma kernels, bf16 at hd 64 and 128: 448 decoder rows (whisper's
# max_target_positions) against 1500 frames (T > S, T not a multiple of the
# 128-row kv tile), and fewer keys than rows (T < S); with the served
# encoder and cross-attention shapes (phase_kernels) and, in the backward,
# the encoder's (4, 1500, 1500) beside them
NON_CAUSAL_CASES = [(b, s, t, h, k, hd, False, 0) for hd in (64, 128)
                    for b, s, t, h, k in [(2, 448, 1500, 16, 16),
                                          (1, 300, 100, 4, 4)]]
WHISPER_ENCODER = (4, 1500, 1500, 16, 16, 64, False, 0)
# bf16 shapes at which the kernel and the plain version are each held
# against an f64 sum (B, S, H, K, hd, causal; T = S): deepseek's shortest
# served prompt (one partial tile), the timed shape, zamba2's longest
# prompt at hd 80, whisper's decoder, llava's prefill and whisper's encoder
FLASH_FLOORS = {"deepseek 75": (1, 75, 32, 32, 128, True),
                "S 2048": (1, 2048, 32, 32, 128, True),
                "zamba2 663": (1, 663, 32, 32, 80, True),
                "whisper decoder": (4, 64, 16, 16, 64, True),
                "llava prefill": (4, 2944, 32, 8, 128, True),
                "whisper encoder": (4, 1500, 16, 16, 64, False)}
F32_TOL = dict(atol=3e-5, rtol=1e-4)       # tests/test_kernels.py
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# Bound on row_rel_err.  Late rows of a long causal prefill average many
# values and are small (|o| ~ sqrt(e/S)), so the absolute tolerance above
# cannot see a wrong weight there; this can.  The bounds are set from the
# rounding error of sound runs on the H100 (PERF.md).
ROW_REL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -5}
MODEL_REL = 5e-4                           # tests/test_models.py:76
# the flash backward's cases: B, S, T, H, K, hd, causal, window, dtype.
# tests/test_kernels.py's flash cases in both dtypes; deepseek-7b's training
# shape; GQA (K 8) with a window of 256; a kv prefix (T > S) at hd 128; hd
# 80 in both dtypes; f32 at the smoke configs' hd 16 (MHA, and GQA with a
# window); one partial tile; GQA (K 4) at hd 64 with a window of 256 over
# several tiles; granite-34b's MQA (48:1) at hd 128; llama4-scout's training
# shape, GQA 5:1; whisper's non-causal cases on the wgmma body (bf16) and
# at hd 64 in f32
TRAIN_SHAPE = (2, 2048, 32, 32, 128)       # B, S, H, K, hd
BWD_CASES = [(b, s, t, h, k, hd, c, w, dt)
             for b, s, t, h, k, hd, c, w in FLASH_CASES
             for dt in (torch.float32, torch.bfloat16)] + [
    (2, 2048, 2048, 32, 32, 128, True, 0, torch.bfloat16),
    (2, 1024, 1024, 32, 8, 128, True, 256, torch.bfloat16),
    (1, 200, 328, 8, 2, 128, True, 0, torch.bfloat16),
    (1, 663, 663, 32, 32, 80, True, 0, torch.bfloat16),
    (1, 300, 300, 8, 2, 80, True, 64, torch.float32),
    (2, 32, 32, 4, 4, 16, True, 0, torch.float32),
    (2, 32, 32, 4, 2, 16, True, 8, torch.float32),
    (1, 20, 20, 4, 2, 64, True, 0, torch.bfloat16),
    (1, 1024, 1024, 16, 4, 64, True, 256, torch.bfloat16),
    (1, 512, 512, 48, 1, 128, True, 0, torch.bfloat16),
    (2, 2048, 2048, 40, 8, 128, True, 0, torch.bfloat16)] + [
    (*c, torch.bfloat16) for c in NON_CAUSAL_CASES + [WHISPER_ENCODER]] + [
    (1, 96, 96, 2, 2, 64, False, 0, torch.float32)]
# cases whose backward runs twice and must give bit-identical dq, dk, dv:
# the training shape, the two windowed GQA cases and whisper's encoder
BWD_REPEAT = [(2, 2048, 2048, 32, 32, 128, True, 0),
              (2, 1024, 1024, 32, 8, 128, True, 256),
              (1, 1024, 1024, 16, 4, 64, True, 256), WHISPER_ENCODER]
# the backward's timed shapes (B, S, H, K, hd, causal; bf16, T = S):
# deepseek-7b's training shape, phi4-mini's GQA at the same length, and
# whisper's encoder at its training batch (non-causal)
BWD_TIMED = {"train": (*TRAIN_SHAPE, True),
             "phi4 gqa": (2, 2048, 24, 8, 128, True),
             "whisper encoder": (8, 1500, 16, 16, 64, False)}
# bf16 shapes at which the backward and the plain one (f32) are each held
# against the plain backward summed in f64 (B, S, H, K, hd; causal)
BWD_FLOORS = {"S 2048": (1, 2048, 32, 32, 128), "hd 80": (1, 663, 32, 32, 80)}
# A gradient row's rms error is taken over the larger of its rms and this
# share of the whole tensor's: rows whose exact gradient vanishes (dq's
# first causal row, where P = 1 and dP - D = 0) hold only rounding
GRAD_ROW_FLOOR = 0.1
# the training path: deepseek-7b at full width and depth, 6 steps of batch
# 2 x 2048 tokens; AdamW's moments in bf16 (f32 moments need 82.9 GB)
TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "deepseek-7b", 6, 2, 2048
TRAIN_SMOKE = ("deepseek-7b", "phi4-mini-3.8b", "gemma3-27b", LLAMA4,
               "arctic-480b", MAMBA2, ZAMBA2, WHISPER, LLAVA)
# 5f, 5g: the encoder-decoder and the VLM at full width and depth, trained
# through make_train_step (their batches carry frames or patches, which the
# Trainer's token loader does not make): (batch, text tokens).  whisper-
# medium: 8 x (1500 frames + 448 decoder tokens, its published
# max_target_positions); llava-next: input_specs' train_4k layout, 2 x (2880
# patches + 1216 tokens) = 2 x 4096 positions
BATCHED_TRAIN = {WHISPER: (8, 448), LLAVA: (2, 4096 - 2880)}
# the MoE training path: llama4-scout at its full widths, cut to 2 of its 48
# layers (6.47 G parameters: with gradients and two bf16 moments 51.8 GB; a
# third layer brings that to 69 GB, which leaves no room for activations)
MOE_TRAIN_LAYERS = 2
TRAIN_REL = 1e-4                           # card vs CPU, grads and losses
# deepseek-7b at full width cut to 2 of its 30 layers, trained in bf16 (the
# training path's kernels: the wgmma forward keeping lse, the wgmma
# backward) against the same weights in f32 (the FMA kernels, held to rows
# of 1e-5 in phase 3) on the card.  Bounds on the step-1 gradients' worst
# leaf (||bf16 - f32|| / ||f32||, 1.4e-2 in sound runs: bf16 activations
# rounded at every op) and on the losses of 3 steps (1.4e-3), about twice
# what sound runs on the H100 gave (PERF.md)
WIDE_LAYERS = 2
WIDE_GRAD_REL, WIDE_LOSS_REL = 3e-2, 3e-3
# tests/test_kernels.py:115-150 -- B, E, C, D, F, act, dtype; the last adds
# the bf16 gelu instantiation, which neither MoE config uses
GMM_CASES = [(2, 4, 8, 32, 64, "swiglu", torch.float32),
             (1, 8, 16, 64, 100, "swiglu", torch.float32),
             (2, 2, 4, 16, 48, "gelu", torch.float32),
             (1, 2, 8, 128, 256, "swiglu", torch.float32),
             (1, 2, 4, 32, 64, "swiglu", torch.bfloat16),
             (2, 2, 4, 16, 48, "gelu", torch.bfloat16)]
# bf16 full-width shapes beside those phase 5 serves (gmm_served_shapes):
# a llama4-scout prefill of 768 tokens (capacity 60, the most the traffic's
# prompt range allows), and arctic's expert widths, 4 of its 128 experts
# at capacity 16
GMM_EXTRA = {"llama4 prefill 768": (1, 16, 60, 5120, 8192),
             "arctic": (1, 4, 16, 7168, 4864)}
# occupancy, shape, act, dtype: buffers as the MoE dispatch fills them
# (live_mask), bf16 at llama4's decode shape and widths, f32 at test widths
GMM_OCCUPANCY = [
    (occ, shape, "swiglu", dt)
    for dt, shape in ((torch.bfloat16, (4, 16, 4, 5120, 8192)),
                      (torch.float32, (4, 16, 4, 64, 96)))
    for occ in ("decode1", "decode4", "last", "zero")] + [
    ("routed", (1, 16, 52, 5120, 8192), "swiglu", torch.bfloat16),
    ("routed", (2, 8, 12, 64, 96), "swiglu", torch.float32),
    ("routed", (2, 8, 12, 64, 96), "gelu", torch.float32),
    ("decode4", (2, 2, 4, 16, 48), "gelu", torch.bfloat16)]
GMM_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
           torch.bfloat16: dict(atol=0.05, rtol=0.05)}
# the grouped FFN's backward: llama4-scout's training shape (2 x 2048 tokens
# top-1 over 16 experts at capacity 160; every row filled, so all 16 experts
# are live with 320 rows each)
GMM_BWD_TRAIN = (2, 16, 160, 5120, 8192)
# its cases: label, (B, E, C, D, F), act, dtype, occupancy (live_mask's, or
# "zero x": X zero on every other slot under a dense dY).  The training
# shape; arctic's expert widths with 4 experts; llama4's widths with buffers
# as the dispatch leaves them (dead experts and rows, dY zero there); gelu
# with zero X rows under nonzero dY rows, in both dtypes; ragged D, F and
# rows; f32 at the smoke configs' widths
GMM_BWD_CASES = [
    ("llama4 train", GMM_BWD_TRAIN, "swiglu", torch.bfloat16, None),
    ("arctic", (2, 4, 32, 7168, 4864), "swiglu", torch.bfloat16, None),
    ("routed", (2, 16, 40, 5120, 8192), "swiglu", torch.bfloat16, "routed"),
    ("gelu zero x", (2, 4, 16, 256, 512), "gelu", torch.bfloat16, "zero x"),
    ("gelu zero x", (2, 3, 4, 16, 32), "gelu", torch.float32, "zero x"),
    ("ragged", (1, 3, 70, 200, 328), "swiglu", torch.bfloat16, None),
    ("ragged routed", (2, 3, 35, 200, 328), "gelu", torch.bfloat16,
     "routed"),
    ("llama4 smoke", (2, 4, 8, 64, 128), "swiglu", torch.float32, None),
    ("arctic smoke", (2, 4, 8, 64, 96), "swiglu", torch.float32, "routed"),
    ("gelu", (2, 2, 4, 16, 48), "gelu", torch.float32, None),
    # B > 2 with C a multiple of neither 32 nor 64 (rows past C in every
    # box); the wgmma body's gelu instantiation on full tiles
    ("routed B 3", (3, 16, 100, 5120, 8192), "swiglu", torch.bfloat16,
     "routed"),
    ("gelu full", (2, 4, 64, 1024, 2048), "gelu", torch.bfloat16, None),
]
# Bound on the grouped FFN's row_rel_err (rows of D), set from the sound
# runs on the H100 (PERF.md): bf16 output and hidden roundings give ~4e-3.
GMM_ROW_REL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
# tests/test_kernels.py:81-83 -- B, NC, L, H, P, N (x f32, cum = cumsum of
# -0.1 dt)
SSD_CASES = [(2, 2, 16, 4, 8, 16), (1, 4, 32, 2, 16, 8),
             (2, 1, 64, 8, 32, 32), (1, 2, 128, 4, 64, 64)]
# the shapes 1- and 2-token prompts give it (L = S for S < chunk)
SSD_SHORT = [(1, 1, 1, 48, 64, 128), (1, 1, 2, 48, 64, 128)]
# x f32 with mild decay, cum = cumsum(-0.01 dt), so that every tile below
# the diagonal weighs in (the served decay, A in [-16, -1], drowns all but
# the nearest tiles): mamba2's 768-token prefill, and an odd head count
# whose last y block holds one head
SSD_MILD = [(1, 3, 256, 48, 64, 128), (1, 2, 200, 5, 64, 128)]
# the new grid and staging paths: B > 1 with two full chunks (the served
# decay and mild decay); x as a view of the model's projection (rows of
# H*P + 2N); x, B and C not 16-byte aligned, and P < 64 (plain loads, not
# cp.async); each as (label, shape, x_bf16, decay, layout), decay None
# being the served A = -linspace(1, 16, H)
SSD_EXTRA = [
    ("B > 1", (2, 2, 256, 48, 64, 128), True, None, "contiguous"),
    ("B > 1, mild decay", (2, 2, 256, 48, 64, 128), True, 0.01, "contiguous"),
    ("projection view", (1, 3, 256, 48, 64, 128), True, None, "view"),
    ("unaligned", (1, 2, 200, 6, 64, 128), True, 0.01, "unaligned"),
    ("unaligned", (1, 2, 100, 6, 64, 128), False, 0.01, "unaligned"),
    ("P 40", (1, 2, 130, 4, 40, 128), True, 0.01, "contiguous"),
    ("P 36, N 20", (1, 2, 130, 4, 36, 20), True, 0.01, "contiguous"),
]
SSD_TOL = {torch.float32: dict(atol=2e-4, rtol=1e-3)}  # test_kernels.py:94
# Bound on the SSD kernel's row_rel_err (rows of P of y and of the states;
# the outputs are f32 whatever x is), set from the sound runs on the H100
# (PERF.md): up to 3.3e-5 in rows of y whose rms is ~1% of their terms',
# where the kernel and the plain version are equally far from an f64 sum.
SSD_ROW_REL = {torch.float32: 1e-4}
SSD_TIMED = (1, 3, 256, 48, 64, 128)   # mamba2's 663-token prefill
# the SSD backward: mamba2-780m's training shape (2 x 2048 tokens, 8 chunks
# of 256) and zamba2-2.7b's, and the smoke configs' (2 x 32 tokens, chunks
# of 8); (B, NC, L, H, P, N)
SSD_BWD_TRAIN = (2, 8, 256, 48, 64, 128)
SSD_BWD_ZAMBA2 = (2, 8, 256, 80, 64, 64)
SSD_BWD_SMOKE = (2, 4, 8, 8, 16, 16)
# its cases: label, shape, x_bf16, decay (None: the served A = -linspace(1,
# 16, H)), layout (as ssd_inputs), and the outputs the loss reads.  The two
# training shapes with x bf16 as the models give it; mamba2's again with x
# f32 (every gradient f32: the arithmetic under the SSD tolerances at full
# size) and under mild decay; the projection view (B > 1); one-chunk
# prompts of ragged L, and L = 1; x, B and C not 16-byte aligned; P < 64
# and N < 64; the tests' cases and the smoke shape in f32; and a loss that
# reads y only, or the states only (the other cotangent absent)
SSD_BWD_CASES = [
    ("mamba2 train", SSD_BWD_TRAIN, True, None, "contiguous", "both"),
    ("zamba2 train", SSD_BWD_ZAMBA2, True, None, "contiguous", "both"),
    ("mamba2 train", SSD_BWD_TRAIN, False, None, "contiguous", "both"),
    ("mamba2 train, mild decay", SSD_BWD_TRAIN, True, 0.01, "contiguous",
     "both"),
    ("projection view", (2, 2, 256, 48, 64, 128), True, None, "view", "both"),
    ("one chunk 200, mild decay", (1, 1, 200, 48, 64, 128), True, 0.01,
     "contiguous", "both"),
    ("one chunk 92", (1, 1, 92, 48, 64, 128), True, None, "contiguous",
     "both"),
    ("L 1", (1, 1, 1, 48, 64, 128), True, None, "contiguous", "both"),
    ("unaligned", (1, 2, 100, 6, 64, 128), False, 0.01, "unaligned", "both"),
    ("P 36, N 20", (2, 2, 130, 4, 36, 20), True, 0.01, "contiguous", "both"),
    *[(f"test {shape}", shape, False, 0.1, "contiguous", "both")
      for shape in SSD_CASES],
    ("smoke", SSD_BWD_SMOKE, False, 0.1, "contiguous", "both"),
    ("y only", (1, 2, 64, 4, 32, 32), False, 0.1, "contiguous", "dy"),
    ("states only", (1, 2, 64, 4, 32, 32), False, 0.1, "contiguous",
     "states"),
    # the 64-row tiles' edges: one row past a tile (L 129, L 65), and x bf16
    # not 16-byte aligned (the bf16 body's plain loads)
    ("L 129", (1, 2, 129, 8, 64, 128), True, None, "contiguous", "both"),
    ("L 65", (1, 1, 65, 4, 64, 64), False, 0.01, "contiguous", "both"),
    ("unaligned", (1, 2, 200, 6, 64, 128), True, 0.01, "unaligned", "both"),
]
# SSD_TOL and SSD_ROW_REL hold the gradients in f32; dxc comes back in x's
# dtype, and a bf16 dxc also carries its own rounding (at most 2^-8 of each
# value, so at most 2^-8 of a row's rms), which is added to both
SSD_BWD_TOL = {torch.float32: SSD_TOL[torch.float32],
               torch.bfloat16: dict(atol=2e-4, rtol=1e-3 + 2 ** -8)}
SSD_BWD_ROW_REL = {torch.float32: SSD_ROW_REL[torch.float32],
                   torch.bfloat16: SSD_ROW_REL[torch.float32] + 2 ** -8}
# one-chunk prompts of 254 and 92 tokens, served as L = S
SSD_ONE_CHUNK = [(1, 1, 254, 48, 64, 128), (1, 1, 92, 48, 64, 128)]
# the main path's traffic: 8 requests, prompts of 64-768 tokens from a seed
SERVE_REQUESTS, SERVE_NEW, SERVE_SLOTS, SERVE_MAX_LEN = 8, 32, 4, 1024
# the batched loop's traffic (whisper, llava): 4 prompts of 64 tokens (after
# llava's 2880 patches), 32 new tokens each
BATCH, BATCH_PROMPT = 4, 64


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


CLOCKS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest rms(got - want) / rms(want) over the (b, s, h) rows: the same
    yardstick for a short softmax and a long one.  (The rms, not the max, of
    a row's error: one-ulp roundings of a row's largest values set a floor
    under the max that hides a small wrong weight.)"""
    got, want = got.float(), want.float()
    err = (got - want).pow(2).mean(-1).sqrt()
    rms = want.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return float((err / rms).max())


def grad_row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``row_rel_err`` for a gradient, each row's rms error over the larger
    of its rms and GRAD_ROW_FLOOR times the tensor's."""
    got, want = got.float(), want.float()
    err = (got - want).pow(2).mean(-1).sqrt()
    floor = GRAD_ROW_FLOOR * float(want.pow(2).mean().sqrt())
    rms = want.pow(2).mean(-1).sqrt().clamp_min(max(floor, 1e-30))
    return float((err / rms).max())


def leaf_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in f64 on ``want``'s device."""
    want = want.detach().double()
    got = got.detach().to(want.device, torch.float64)
    return float((got - want).norm() / (want.norm() + 1e-30))


def serve_prompts(vocab: int) -> list[np.ndarray]:
    """The prompts phase 5 serves, drawn from a fixed seed."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 769, size=SERVE_REQUESTS)
    return [rng.integers(0, vocab, size=int(n)) for n in lens]


def gmm_served_shapes() -> dict:
    """label -> (B, E, C, D, F): the grouped FFN's shapes on phase 5's llama4
    path.  Each request is prefilled alone at its own length, so each
    served prompt gives its own capacity; decode runs all slots at once."""
    from repro_torch.configs import get_config
    from repro_torch.models.mlp import moe_capacity
    cfg = get_config(LLAMA4)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    shapes = {f"llama4 prefill {len(p)}": (1, e, moe_capacity(cfg, len(p)),
                                           d, f)
              for p in serve_prompts(cfg.vocab)}
    shapes["llama4 decode"] = (SERVE_SLOTS, e, moe_capacity(cfg, 1), d, f)
    return shapes


def ssd_served_shapes(arch: str = MAMBA2) -> dict:
    """label -> (B, NC, L, H, P, N): the SSD kernel's shapes on phase 5's
    mamba2 (or zamba2) path.  Each request is prefilled alone;
    ``ssd_chunked`` takes L = min(chunk, S) and pads the tail to NC whole
    chunks."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    shapes = {}
    for p in serve_prompts(cfg.vocab):
        s = len(p)
        l = min(cfg.ssm_chunk, s)
        shapes[f"{arch.split('-')[0]} prefill {s}"] = (
            1, -(-s // l), l, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    return shapes


def hold(name: str, cases: list, tols: dict, row_bounds: dict) -> float:
    """Hold a kernel against its plain version on the card.  Each case is
    (label, dtype, run, is_main): ``run()`` returns the kernel's output and
    the plain version's on the same inputs.  They must agree within
    ``tols[dtype]``, and the worst row's rms error within
    ``row_bounds[dtype]``.  Returns the largest abs error at the main paths'
    shapes (``is_main``)."""
    main_err, worst = 0.0, {}
    for label, dtype, run, is_main in cases:
        got, want = run()
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape, label
        err = float((got.float() - want.float()).abs().max())
        rel = row_rel_err(got, want)
        if is_main:
            main_err = max(main_err, err)
        worst[dtype] = max(worst.get(dtype, 0.0), rel)
        tol, bound = tols[dtype], row_bounds[dtype]
        say(f"[kernels] {name} {label} {str(dtype)[6:]}: max abs err "
            f"{err:.3e} (atol {tol['atol']}, rtol {tol['rtol']}), row rel err "
            f"{rel:.3e} (< {bound:.3e})")
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert rel < bound, f"{name} {label}: row rel err {rel}"
        del got, want
    torch.cuda.empty_cache()
    say(f"[kernels] {name}: {len(cases)} cases agree; largest row rel err: "
        + ", ".join(f"{str(dt)[6:]} {r:.3e}" for dt, r in worst.items())
        + f"; largest abs err at the main paths' shapes {main_err:.3e}")
    return main_err


def qkv(b, s, t, h, k, hd, dtype, gen):
    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return draw(b, s, h, hd), draw(b, t, k, hd), draw(b, t, k, hd)


# ------------------------------------------------------------------ phases
def phase_info() -> str:
    line = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"[info] card: {line}")
    say(f"[info] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, devices "
        f"{torch.cuda.device_count()}")
    return line


def phase_build() -> dict:
    """Build every kernel; name -> ptxas's lines (entry, registers, spills),
    which also go into the run's record."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    say(f"[build] {len(paths)} kernel(s) built in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    report = {}
    for name in paths:
        report[name] = [ln.strip() for ln in _build.build_log(name)
                        .splitlines() if "registers" in ln or "spill" in ln
                        or "entry function" in ln or "Loss" in ln
                        or "warning" in ln]
        for ln in report[name]:
            say(f"[build] {name}: {ln}")
        say(f"[build] {name} by instantiation: "
            + "; ".join(f"{k}: {v}" for k, v in
                        instantiations(report[name]).items()))
    wgmma_bwd_report(report["flash_attn_bwd"])
    wgmma_gmm_bwd_report(report["moe_gmm_bwd"])
    ssd_bwd_report(report["ssd_intra_chunk_bwd"])
    return report


def wgmma_bwd_report(lines: list[str]) -> None:
    """The wgmma backward's registers and spills, which must be none."""
    new = {k: v for k, v in instantiations(lines).items()
           if k.startswith("flash_attn_bwd_wgmma")}
    say(f"[build] flash_attn_bwd wgmma body: {new}")
    assert len(new) == 2, f"want the hd 64 and 128 wgmma bodies, got {new}"
    for k, v in new.items():
        assert v.endswith(" 0 bytes spilled"), f"{k} spills: {v}"


def wgmma_gmm_bwd_report(lines: list[str]) -> None:
    """The grouped FFN backward's wgmma body: its six instantiations (three
    passes, swiglu and gelu) with their registers; no spill, and no ptxas
    note that it serialized the wgmma products (C7520)."""
    new = {k: v for k, v in instantiations(lines).items()
           if "Pass<" in k}
    say(f"[build] moe_gmm_bwd wgmma body: {new}")
    assert len(new) == 6, f"want six wgmma instantiations, got {new}"
    for k, v in new.items():
        assert v.endswith(" 0 bytes spilled"), f"{k} spills: {v}"
    serial = [ln for ln in lines if "C7520" in ln or "serialized" in ln]
    assert not serial, f"moe_gmm_bwd: wgmma serialized: {serial}"


def ssd_bwd_report(lines: list[str]) -> None:
    """The SSD backward's eleven instantiations (the per-head, dCB and state
    term kernels, each for f32 x, bf16 x by cp.async and bf16 x by plain
    loads; dB/dC by cp.async and by plain loads) with their registers: none
    may spill."""
    new = {k: v for k, v in instantiations(lines).items()
           if k.startswith("ssd_bwd_")}
    say(f"[build] ssd_intra_chunk_bwd: {new}")
    assert len(new) == 11, f"want 11 SSD backward instantiations, got {new}"
    for k, v in new.items():
        assert v.endswith(" 0 bytes spilled"), f"{k} spills: {v}"


def instantiations(lines: list[str]) -> dict:
    """ptxas's report as {"kernel<template arg>": "R registers, S bytes
    spilled"}, the kernel named from its mangled entry (``..._mmaILi80EE``
    is ``flash_attn_fwd_mma<80>``)."""
    import re
    out, label, spill = {}, None, "?"
    for ln in lines:
        if "entry function" in ln:
            mangled = ln.split("'")[1]
            name = re.findall(r"\d+([a-z_]+)I", mangled)
            arg = re.search(r"ILi(\d+)E", mangled)
            # a kernel templated on a pass (moe_gmm_bwd's wg::pass<P>)
            policy = re.search(r"\d+([A-Za-z]+Pass)ILi(\d+)E", mangled)
            # or on x's type and the staging (the SSD kernels' <XT, kAsync>
            # or <kAsync>)
            typed = re.search(r"I(f|13__nv_bfloat16)?Lb([01])E", mangled)
            staging = ""
            if typed:
                staging = "cp.async" if typed.group(2) == "1" else "plain"
                if typed.group(1):
                    staging = ("f32, " if typed.group(1) == "f" else
                               "bf16, ") + staging
            label = (f"{policy.group(1)}<{policy.group(2)}>" if policy else
                     (name[-1] if name else mangled)
                     + (f"<{arg.group(1)}>" if arg else "")
                     + (f"<{staging}>" if staging else ""))
            if label in out:                   # another type argument
                label += f" #{sum(k.startswith(label) for k in out) + 1}"
        elif "spill stores" in ln and label:
            spill = ln.split(",")[1].split("bytes")[0].strip()
        elif "registers" in ln and label:
            regs = re.search(r"Used (\d+) registers", ln)
            out[label] = (f"{regs.group(1) if regs else '?'} registers, "
                          f"{spill} bytes spilled")
            label = None
    return out


def phase_kernels() -> float:
    """Flash attention vs its plain version; returns the largest abs error
    at the main paths' shapes (those served in phase 5, and
    PREFILL_CASES)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (attention_reference,
                                                     flash_attention)
    gen = torch.Generator("cuda").manual_seed(0)
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(b, s, t, h, k, hd, c, w, dt, False)
             for b, s, t, h, k, hd, c, w in FLASH_CASES for dt in dtypes]
    cases += [(1, 64, 64, 4, 2, 32, True, 0, dt, False) for dt in dtypes]
    cases += [(*c, torch.bfloat16, False) for c in WGMMA_CASES]
    cases += [(b, s, s, h, k, hd, True, w, torch.bfloat16, True)
              for b, s, h, k, hd, w in PREFILL_CASES]
    for arch in ("deepseek-7b", LLAMA4, ZAMBA2):
        cfg = get_config(arch)
        windows = sorted({0 if cfg.is_global_layer(i) else
                          cfg.sliding_window for i in range(cfg.n_layers)})
        cases += [(1, len(p), len(p), cfg.n_heads, cfg.n_kv_heads,
                   cfg.head_dim, True, w, torch.bfloat16, True)
                  for p in serve_prompts(cfg.vocab) for w in windows]
    cases += [(*c, dt, False) for c in HD80_CASES for dt in dtypes]
    # the batched paths' prefills: whisper's decoder self-attention, and
    # llava's 2880 patches + prompt
    for arch in (WHISPER, LLAVA):
        cfg = get_config(arch)
        s = BATCH_PROMPT + (cfg.n_patches if cfg.family == "vlm" else 0)
        cases.append((BATCH, s, s, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, True, 0, torch.bfloat16, True))
    # whisper's non-causal attentions (drawn after every earlier case): the
    # cases of NON_CAUSAL_CASES, and the batched path's encoder over its
    # frames and cross-attention of the prompt against them
    cfg = get_config(WHISPER)
    cases += [(*c, torch.bfloat16, False) for c in NON_CAUSAL_CASES]
    cases += [(BATCH, s, cfg.enc_len, cfg.n_heads, cfg.n_kv_heads,
               cfg.head_dim, False, 0, torch.bfloat16, True)
              for s in (cfg.enc_len, BATCH_PROMPT)]
    assert cases[-2][:8] == WHISPER_ENCODER

    def run(b, s, t, h, k, hd, causal, window, dtype):
        q, kk, v = qkv(b, s, t, h, k, hd, dtype, gen)
        return (flash_attention(q, kk, v, causal=causal, window=window),
                attention_reference(q, kk, v, causal=causal, window=window))

    err = hold("flash_attn_fwd",
               [(tuple(c[:8]), c[8], lambda c=c: run(*c[:9]), c[9])
                for c in cases],
               {torch.float32: F32_TOL, torch.bfloat16: BF16_TOL}, ROW_REL)
    # the rounding floor under BF16_TOL: the kernel (f32 scores) and the
    # plain version (bf16 scores, as the reference's einsum gives them) each
    # against the plain version summed in f64 on the same bf16 inputs; the
    # kernel's worst row may be no farther from it than the plain one's
    fgen = torch.Generator("cuda").manual_seed(7)
    for label, (b, s, h, k, hd, causal) in FLASH_FLOORS.items():
        q, kk, v = qkv(b, s, s, h, k, hd, torch.bfloat16, fgen)
        exact = attention_reference(q.double(), kk.double(), v.double(),
                                    causal=causal)
        kernel = row_rel_err(flash_attention(q, kk, v, causal=causal), exact)
        plain = row_rel_err(attention_reference(q, kk, v, causal=causal),
                            exact)
        say(f"[kernels] flash_attn_fwd {label} {(b, s, h, k, hd)} bf16 "
            f"{'causal' if causal else 'non-causal'}: row rel err against "
            f"an f64 sum: kernel {kernel:.3e}, plain {plain:.3e}")
        assert kernel <= plain, f"flash {label}: kernel farther from f64"
        del q, kk, v, exact
    torch.cuda.empty_cache()
    return err


def wrapper_grads(q, k, v, do, causal: bool, window: int):
    """``flash_attention`` as training calls it, on copies of q, k, v that
    require grad: the autograd Function's forward kernel (keeping the row
    logsumexp), then ``o.backward(do)`` through the backward kernel, which
    must count one backward call.  Returns o, the lse the Function saved
    for its backward, and (dq, dk, dv)."""
    from repro_torch.kernels.flash_attention import flash_attention
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    before = flash_attention.backward_launches
    o = flash_attention(*leaves, causal=causal, window=window)
    assert "FlashAttention" in type(o.grad_fn).__name__
    lse = o.grad_fn.saved_tensors[4]
    o.backward(do)
    assert flash_attention.backward_launches == before + 1
    return o.detach(), lse, tuple(x.grad for x in leaves)


def phase_flash_backward() -> float:
    """The flash backward and the forward's row logsumexp through the
    wrapper that training calls (``wrapper_grads``) against their plain
    versions on the card, at BWD_CASES: o against ``attention_reference``
    with the forward's tolerances and row bounds; the saved lse against its
    ``return_lse`` in f32; dq, dk, dv against ``attention_backward_reference``
    run in f32 from the same bf16 inputs, o and lse, with the forward's
    elementwise tolerances (atol scaled to each gradient's max |value|) and
    row bounds (``grad_row_rel_err``).  Returns the largest abs error of a
    gradient at the training shape."""
    from repro_torch.kernels.flash_attention import (
        attention_backward_reference, attention_reference, flash_attention)
    saved = flash_attention.launches, flash_attention.backward_launches
    gen = torch.Generator("cuda").manual_seed(8)
    main_err, worst, lse_worst = 0.0, {}, 0.0
    for b, s, t, h, k, hd, causal, window, dt in BWD_CASES:
        q, kk, v = qkv(b, s, t, h, k, hd, dt, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        o, lse, got = wrapper_grads(q, kk, v, do, causal, window)
        with torch.no_grad():
            want_o = attention_reference(q, kk, v, causal=causal,
                                         window=window)
            _, want_lse = attention_reference(
                q.float(), kk.float(), v.float(), causal=causal,
                window=window, return_lse=True)
            want = attention_backward_reference(
                q.float(), kk.float(), v.float(), o.float(), lse,
                do.float(), causal=causal, window=window)
        torch.cuda.synchronize()
        label = f"{(b, s, t, h, k, hd, causal, window)} {str(dt)[6:]}"
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        o_err = float((o.float() - want_o.float()).abs().max())
        o_rel = row_rel_err(o, want_o)
        assert o.dtype == dt and o.shape == want_o.shape, label
        torch.testing.assert_close(o.float(), want_o.float(), **tol)
        assert o_rel < ROW_REL[dt], f"flash fwd (lse) {label}: row {o_rel}"
        lse_err = float((lse - want_lse).abs().max())
        lse_worst = max(lse_worst, lse_err)
        torch.testing.assert_close(lse, want_lse, **F32_TOL)
        parts = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            assert g.dtype == dt and g.shape == w.shape, (label, name)
            top = float(w.abs().max())
            err = float((g.float() - w).abs().max())
            rel = grad_row_rel_err(g, w)
            worst[dt] = max(worst.get(dt, 0.0), rel)
            if (b, s, h, k, hd) == TRAIN_SHAPE:
                main_err = max(main_err, err)
            parts.append(f"{name} {err:.3e} of max {top:.3e}, row {rel:.3e}")
            torch.testing.assert_close(g.float(), w,
                                       atol=tol["atol"] * top,
                                       rtol=tol["rtol"])
            assert rel < ROW_REL[dt], f"flash bwd {label} {name}: row {rel}"
        say(f"[kernels] flash_attn_bwd {label}: o max abs err {o_err:.3e}, "
            f"row {o_rel:.3e}; lse max abs err {lse_err:.3e}; "
            + "; ".join(parts) + f" (atol {tol['atol']} x max, rtol "
            f"{tol['rtol']}; row < {ROW_REL[dt]:.3e})")
        if (b, s, t, h, k, hd, causal, window) in BWD_REPEAT:
            _, _, again = wrapper_grads(q, kk, v, do, causal, window)
            same = [torch.equal(g, a) for g, a in zip(got, again)]
            say(f"[kernels] flash_attn_bwd {label}: a second call gives "
                f"bit-identical dq, dk, dv: {same}")
            assert all(same), f"flash bwd {label}: not deterministic"
            del again
        del q, kk, v, do, o, lse, got, want, want_o, want_lse
    torch.cuda.empty_cache()
    say(f"[kernels] flash_attn_bwd: {len(BWD_CASES)} cases through "
        f"flash_attention's autograd Function agree (one backward call "
        f"each); largest row rel err: " + ", ".join(
            f"{str(dt)[6:]} {r:.3e}" for dt, r in worst.items())
        + f"; lse largest abs err {lse_worst:.3e}; largest abs err at the "
        f"training shape {main_err:.3e}")
    # the rounding floor: the kernel (P and dS rounded to bf16 for the
    # second products) and the plain backward in f32, each against the plain
    # function in f64 on the same bf16 inputs
    fgen = torch.Generator("cuda").manual_seed(9)
    for label, (b, s, h, k, hd) in BWD_FLOORS.items():
        q, kk, v = qkv(b, s, s, h, k, hd, torch.bfloat16, fgen)
        do = torch.randn(q.shape, generator=fgen, device="cuda").to(q.dtype)
        o, lse, kernel = wrapper_grads(q, kk, v, do, True, 0)
        with torch.no_grad():
            x64 = [x.double() for x in (q, kk, v)]
            o64, lse64 = attention_reference(*x64, return_lse=True)
            exact = attention_backward_reference(*x64, o64, lse64,
                                                 do.double())
            plain = attention_backward_reference(
                q.float(), kk.float(), v.float(), o.float(), lse, do.float())
        say(f"[kernels] flash_attn_bwd {label} {(b, s, h, k, hd)} bf16: row "
            f"rel err against an f64 sum: " + "; ".join(
                f"{n} kernel {grad_row_rel_err(g, e):.3e}, plain f32 "
                f"{grad_row_rel_err(p, e):.3e}"
                for n, g, p, e in zip(("dq", "dk", "dv"), kernel, plain,
                                      exact)))
        del q, kk, v, do, o, lse, x64, o64, lse64, exact, kernel, plain
    torch.cuda.empty_cache()
    flash_attention.launches, flash_attention.backward_launches = saved
    return main_err


def gmm_inputs(b, e, c, d, f, dtype, gen):
    def draw(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(
            dtype)
    return (draw(b, e, c, d, std=0.5), draw(e, d, f, std=d ** -0.5),
            draw(e, d, f, std=d ** -0.5), draw(e, f, d, std=f ** -0.5))


def live_mask(shape, occupancy: str, gen) -> torch.Tensor | None:
    """(B, E, C, 1) 0/1 mask of the rows a buffer of ``occupancy`` holds, as
    the MoE dispatch fills them (None: every row).  ``decode1`` / ``decode4``:
    one token in slot 0 of 1 / 4 distinct experts, each batch row one token
    (a decode step with top-1 routing); ``last``: one expert whose only live
    row is the last (b, slot) of its (B, C) block; ``routed``: each batch
    row's C * E // 2 tokens routed top-1 in token order into their experts'
    next free slots, capacity C, from router weights that leave expert 0
    dead; ``zero``: no live row."""
    if occupancy is None:
        return None
    b, e, c = shape[:3]
    m = torch.zeros(b, e, c, 1, device="cuda")
    if occupancy in ("decode1", "decode4"):
        n = 1 if occupancy == "decode1" else min(4, e)
        experts = torch.randperm(e, generator=gen, device="cuda")[:n]
        for i in range(b):
            m[i, experts[i % n], 0] = 1
    elif occupancy == "last":
        m[b - 1, e // 2, c - 1] = 1
    elif occupancy == "routed":
        probs = torch.rand(e, generator=gen, device="cuda") ** 2
        probs[0] = 0
        for i in range(b):
            tok = torch.multinomial(probs, c * e // 2, replacement=True,
                                    generator=gen)
            fill = [0] * e
            for ex in tok.tolist():
                if fill[ex] < c:
                    m[i, ex, fill[ex]] = 1
                    fill[ex] += 1
    return m


def phase_gmm() -> float:
    """The grouped expert FFN vs its plain version, at the test cases, at
    every shape phase 5's llama4 path gives it, at GMM_EXTRA, and at buffers
    whose occupancy the main path gives (GMM_OCCUPANCY: dead experts and dead
    rows, whose outputs must be exact zeros); returns the largest abs error
    at the served shapes."""
    from repro_torch.kernels.moe_gmm import grouped_ffn, grouped_ffn_reference
    gen = torch.Generator("cuda").manual_seed(1)
    cases = [(f"{tuple(shape)} {act}", shape, act, dt, None, False)
             for *shape, act, dt in GMM_CASES]
    cases += [(f"{label} {shape} swiglu", shape, "swiglu", torch.bfloat16,
               None, main)
              for shapes, main in ((gmm_served_shapes(), True),
                                   (GMM_EXTRA, False))
              for label, shape in shapes.items()]
    cases += [(f"{occ} {tuple(shape)} {act}", shape, act, dt, occ, False)
              for occ, shape, act, dt in GMM_OCCUPANCY]

    def run(shape, act, dtype, occupancy):
        x = gmm_inputs(*shape, dtype, gen)
        mask = live_mask(shape, occupancy, gen)
        if mask is not None:
            x = (x[0] * mask.to(dtype), *x[1:])
        got = grouped_ffn(*x, act=act)
        dead = (x[0] == 0).all(-1)
        # the skip's identity: dead rows and dead experts give exact zeros
        assert torch.equal(got[dead], torch.zeros_like(got[dead])), \
            f"moe_gmm {occupancy} {shape}: a dead row is not exactly zero"
        live_e = int((~dead).any(-1).any(0).sum())
        if occupancy:
                say(f"[kernels] moe_gmm {occupancy} {tuple(shape)}: {live_e} "
                f"of {shape[1]} experts live, {int((~dead).sum())} of "
                f"{dead.numel()} rows; every dead row's output exactly 0")
        return got, grouped_ffn_reference(*x, act=act)

    return hold("moe_gmm",
                [(label, dt, lambda s=s, a=a, dt=dt, o=o: run(s, a, dt, o),
                  main)
                 for label, s, a, dt, o, main in cases],
                GMM_TOL, GMM_ROW_REL)


def gmm_bwd_inputs(shape, act: str, dtype, occupancy, gen):
    """buf, w_in, w_gate, w_out and the output's cotangent dy on the card.
    ``occupancy``: None (every row), a ``live_mask`` occupancy (buf and dy
    zero on its dead rows, as the dispatch leaves them) or "zero x" (X zero
    on every other slot, dy dense: the rows gelu must keep live)."""
    b, e, c, d, f = shape
    buf, wi, wg, wo = gmm_inputs(b, e, c, d, f, dtype, gen)
    dy = torch.randn((b, e, c, d), generator=gen, device="cuda").to(dtype)
    if occupancy == "zero x":
        buf[:, :, ::2] = 0
    elif occupancy is not None:
        mask = live_mask((b, e, c), occupancy, gen).to(dtype)
        buf, dy = buf * mask, dy * mask
    return buf, wi, wg, wo, dy


def gmm_grads(buf, wi, wg, wo, dy, act: str):
    """``grouped_ffn`` as training calls it, on copies that require grad:
    ``GroupedFFN``'s forward kernel, then ``out.backward(dy)`` through the
    backward kernel, which must count one backward launch.  Returns (dbuf,
    dw_in, dw_gate, dw_out)."""
    from repro_torch.kernels.moe_gmm import grouped_ffn
    leaves = [x.detach().clone().requires_grad_() for x in (buf, wi, wg, wo)]
    before = grouped_ffn.backward_launches
    out = grouped_ffn(*leaves, act=act)
    assert "GroupedFFN" in type(out.grad_fn).__name__
    out.backward(dy)
    assert grouped_ffn.backward_launches == before + 1
    return tuple(x.grad for x in leaves)


def phase_gmm_backward() -> float:
    """The grouped FFN's backward through ``GroupedFFN`` (``gmm_grads``)
    against ``grouped_ffn_backward_reference`` run in f32 on the card from
    the same inputs, at GMM_BWD_CASES: each gradient within GMM_TOL (atol
    scaled to its max |value|) and its worst row within GMM_ROW_REL
    (``grad_row_rel_err``); dX rows of dead rows and every weight gradient
    of a dead expert exactly zero; a second call at the training shape bit
    for bit the same.  Returns the largest abs error at the training
    shape."""
    from repro_torch.kernels.moe_gmm import (grouped_ffn,
                                             grouped_ffn_backward_reference)
    saved = grouped_ffn.launches, grouped_ffn.backward_launches
    gen = torch.Generator("cuda").manual_seed(13)
    main_err, worst = 0.0, {}
    for label, shape, act, dt, occupancy in GMM_BWD_CASES:
        x = gmm_bwd_inputs(shape, act, dt, occupancy, gen)
        got = gmm_grads(*x, act)
        with torch.no_grad():
            want = grouped_ffn_backward_reference(*(t.float() for t in x),
                                                  act=act)
        torch.cuda.synchronize()
        tag = f"{label} {shape} {act} {str(dt)[6:]}"
        tol, bound = GMM_TOL[dt], GMM_ROW_REL[dt]
        parts = []
        for name, g, w in zip(("dbuf", "dw_in", "dw_gate", "dw_out"), got,
                              want):
            assert g.dtype == dt and g.shape == w.shape, (tag, name)
            top = float(w.abs().max())
            err = float((g.float() - w).abs().max())
            rel = grad_row_rel_err(g, w) if top > 0 else 0.0
            worst[dt] = max(worst.get(dt, 0.0), rel)
            if shape == GMM_BWD_TRAIN:
                main_err = max(main_err, err)
            parts.append(f"{name} {err:.3e} of max {top:.3e}, row {rel:.3e}")
            torch.testing.assert_close(g.float(), w, atol=tol["atol"] * top,
                                       rtol=tol["rtol"])
            assert rel < bound, f"moe_gmm_bwd {tag} {name}: row {rel}"
        # the skip's identities: dead rows' dX and dead experts' weight
        # gradients are exact zeros (gelu keeps rows with a nonzero dY live)
        dead = (x[0] == 0).all(-1)
        if act == "gelu":
            dead &= (x[4] == 0).all(-1)
        dead_e = dead.all(-1).all(0)
        assert not got[0][dead].any(), f"moe_gmm_bwd {tag}: dead dX row"
        assert all(not g[dead_e].any() for g in got[1:]), \
            f"moe_gmm_bwd {tag}: a dead expert's weight gradient"
        say(f"[kernels] moe_gmm_bwd {tag}: "
            + (f"{int((~dead_e).sum())} of {shape[1]} experts live, "
               f"{int((~dead).sum())} of {dead.numel()} rows, dead ones "
               f"exactly 0; " if occupancy else "")
            + "; ".join(parts) + f" (atol {tol['atol']} x max, rtol "
            f"{tol['rtol']}; row < {bound:.3e})")
        if shape == GMM_BWD_TRAIN:
            again = gmm_grads(*x, act)
            same = [torch.equal(g, a) for g, a in zip(got, again)]
            say(f"[kernels] moe_gmm_bwd {tag}: a second call gives "
                f"bit-identical dbuf, dw_in, dw_gate, dw_out: {same}")
            assert all(same), f"moe_gmm_bwd {tag}: not deterministic"
            del again
        del x, got, want
        torch.cuda.empty_cache()
    say(f"[kernels] moe_gmm_bwd: {len(GMM_BWD_CASES)} cases through "
        f"GroupedFFN agree (one backward launch each); largest row rel err: "
        + ", ".join(f"{str(dt)[6:]} {r:.3e}" for dt, r in worst.items())
        + f"; largest abs err at the training shape {main_err:.3e}")
    grouped_ffn.launches, grouped_ffn.backward_launches = saved
    return main_err


def ssd_inputs(b, nc, l, h, p, n, x_bf16: bool, gen, decay=None,
               layout: str = "contiguous"):
    """xc, dtc, cum, bc, cc on the card.  ``x_bf16``: as the mamba2 path
    gives them, x in bf16 and B, C f32 carrying bf16 values; else f32, as
    tests/test_kernels.py draws them.  cum = cumsum(dt A), with A =
    -linspace(1, 16, H) (the served decay) when ``decay`` is None, else
    A = -decay.  ``layout``: "contiguous"; "view", x a slice of rows of
    H*P + 2N values as the model's projection hands it in; "unaligned", x,
    B and C slices that start one element into wider rows."""
    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dtc = torch.nn.functional.softplus(draw(b, nc, l, h))
    a = (-torch.linspace(1.0, 16.0, h, device="cuda") if decay is None
         else torch.full((h,), -decay, device="cuda"))
    cum = torch.cumsum(dtc * a, dim=2)
    xd = torch.bfloat16 if x_bf16 else torch.float32
    hp = h * p
    if layout == "contiguous":
        xc = draw(b, nc, l, h, p).to(xd)
    elif layout == "view":
        xc = draw(b, nc, l, hp + 2 * n).to(xd)[..., :hp].unflatten(-1, (h, p))
    else:
        xc = draw(b, nc, l, hp + 1).to(xd)[..., 1:].unflatten(-1, (h, p))

    def bmat():
        if layout == "unaligned":     # f32 values; a cast would copy
            return draw(b, nc, l, n + 1)[..., 1:]
        m = draw(b, nc, l, n)
        return m.to(torch.bfloat16).float() if x_bf16 else m
    return xc, dtc, cum, bmat(), bmat()


def ssd_rows(y, st):
    """y and the states as rows of P, held together."""
    p = y.shape[-1]
    return torch.cat([y.reshape(-1, p), st.reshape(-1, p)])


def phase_ssd() -> float:
    """The SSD intra-chunk kernel vs its plain version, at the test cases,
    at every shape phase 5's mamba2 and zamba2 paths give it, at each of
    mamba2's with
    one chunk (a ragged L) under mild decay, at the mild-decay cases and at
    SSD_EXTRA; returns the largest abs error at the served shapes.  y and
    the states are held together, as rows of P."""
    from repro_torch.kernels.ssd import (ssd_intra_chunk,
                                         ssd_intra_chunk_reference)
    gen = torch.Generator("cuda").manual_seed(5)
    served = ssd_served_shapes()
    cases = [(f"{shape} x f32", shape, False, 0.1, "contiguous", False)
             for shape in SSD_CASES]
    cases += [(f"{label} {shape} x bf16", shape, True, None, "contiguous",
               True) for label, shape in (*served.items(),
                                          *ssd_served_shapes(ZAMBA2).items())]
    cases += [(f"short prompt {shape} x bf16", shape, True, None,
               "contiguous", False) for shape in SSD_SHORT]
    cases += [(f"{label} {shape} x bf16, mild decay", shape, True, 0.01,
               "contiguous", False)
              for label, shape in served.items() if shape[1] == 1]
    cases += [(f"{shape} x f32, mild decay", shape, False, 0.01,
               "contiguous", False) for shape in SSD_MILD]
    cases += [(f"{label} {shape} x {'bf16' if bf else 'f32'}", shape, bf,
               decay, layout, False)
              for label, shape, bf, decay, layout in SSD_EXTRA]

    def run(shape, x_bf16, decay, layout):
        x = ssd_inputs(*shape, x_bf16, gen, decay, layout)
        return (ssd_rows(*ssd_intra_chunk(*x)),
                ssd_rows(*ssd_intra_chunk_reference(*x)))

    err = hold("ssd_intra_chunk",
               [(label, torch.float32,
                 lambda s=s, bf=bf, d=d, lay=lay: run(s, bf, d, lay), main)
                for label, s, bf, d, lay, main in cases],
               SSD_TOL, SSD_ROW_REL)
    # the rounding floor under SSD_ROW_REL: the kernel (products on bf16
    # tensor cores, the f32 operand split in three) and the plain version
    # each against the plain version summed in f64, at the shortest and the
    # longest served prompt and at a long one under mild decay
    floors = [(label, served[label], None) for label in (
        min(served, key=lambda lb: served[lb][1] * served[lb][2]),
        max(served, key=lambda lb: served[lb][1] * served[lb][2]))]
    floors.append(("mild decay", SSD_TIMED, 0.01))
    for label, shape, decay in floors:
        x = ssd_inputs(*shape, True, gen, decay)
        exact = ssd_rows(*ssd_intra_chunk_reference(*(t.double() for t in x)))
        kernel = row_rel_err(ssd_rows(*ssd_intra_chunk(*x)), exact)
        plain = row_rel_err(ssd_rows(*ssd_intra_chunk_reference(*x)), exact)
        say(f"[kernels] ssd_intra_chunk {label} {shape}: row rel err against "
            f"an f64 sum: kernel {kernel:.3e}, plain f32 {plain:.3e}")
    return err


def ssd_grads(x, dy, ds):
    """``ssd_intra_chunk`` as training calls it, on aliases of the inputs
    that require grad (their strides kept: the model's views reach the
    kernel as they are): ``SSDIntraChunk``'s forward kernel, then the
    backward kernel from the cotangents given (None: that output is not
    read), which must count one backward call.  Returns the five inputs'
    gradients."""
    from repro_torch.kernels.ssd import ssd_intra_chunk
    leaves = [t.detach().requires_grad_() for t in x]
    before = ssd_intra_chunk.backward_launches
    outs = ssd_intra_chunk(*leaves)
    assert "SSDIntraChunk" in type(outs[0].grad_fn).__name__
    read = [(o, g) for o, g in zip(outs, (dy, ds)) if g is not None]
    torch.autograd.backward([o for o, _ in read], [g for _, g in read])
    assert ssd_intra_chunk.backward_launches == before + 1
    return tuple(t.grad for t in leaves)


def ssd_cotangents(shape, which: str, gen):
    """dy (B,NC,L,H,P) and d states (B,NC,H,N,P), f32 on the card; None for
    an output the loss does not read (``which``: "both", "dy", "states")."""
    b, nc, l, h, p, n = shape
    dy = (torch.randn((b, nc, l, h, p), generator=gen, device="cuda")
          if which != "states" else None)
    ds = (torch.randn((b, nc, h, n, p), generator=gen, device="cuda")
          if which != "dy" else None)
    return dy, ds


def phase_ssd_backward() -> float:
    """The SSD backward through ``SSDIntraChunk`` (``ssd_grads``) against
    ``ssd_intra_chunk_backward_reference`` run in f32 on the card from the
    same inputs, at SSD_BWD_CASES: each gradient within SSD_BWD_TOL (atol
    scaled to its max |value|) and its worst row within SSD_BWD_ROW_REL
    (``grad_row_rel_err``); a second call at the two training shapes bit
    for bit the same.  Then the rounding floor at mamba2's training shape:
    the kernel and the plain version in f32 each against the plain version
    in f64.  Returns the largest abs error at the training shapes."""
    from repro_torch.kernels.ssd import (ssd_intra_chunk,
                                         ssd_intra_chunk_backward_reference)
    saved = ssd_intra_chunk.launches, ssd_intra_chunk.backward_launches
    gen = torch.Generator("cuda").manual_seed(15)
    names = ("dxc", "ddtc", "dcum", "dbc", "dcc")
    main_err, worst = 0.0, {}
    for label, shape, bf, decay, layout, which in SSD_BWD_CASES:
        x = ssd_inputs(*shape, bf, gen, decay, layout)
        dy, ds = ssd_cotangents(shape, which, gen)
        got = ssd_grads(x, dy, ds)
        with torch.no_grad():
            want = ssd_intra_chunk_backward_reference(
                *(t.float() for t in x), dy, ds)
        torch.cuda.synchronize()
        train = shape in (SSD_BWD_TRAIN, SSD_BWD_ZAMBA2)
        tag = (f"{label} {shape} x {'bf16' if bf else 'f32'}"
               + ("" if which == "both" else f", {which} only"))
        parts = []
        for name, g, w in zip(names, got, want):
            dt = x[0].dtype if name == "dxc" else torch.float32
            assert g.shape == w.shape and g.dtype == dt, (tag, name)
            tol, bound = SSD_BWD_TOL[g.dtype], SSD_BWD_ROW_REL[g.dtype]
            top = float(w.abs().max())
            err = float((g.float() - w).abs().max())
            rel = grad_row_rel_err(g, w) if top > 0 else 0.0
            worst[g.dtype] = max(worst.get(g.dtype, 0.0), rel)
            if train:
                main_err = max(main_err, err)
            parts.append(f"{name} {err:.3e} of max {top:.3e}, row {rel:.3e}")
            torch.testing.assert_close(g.float(), w, atol=tol["atol"] * top,
                                       rtol=tol["rtol"])
            assert rel < bound, f"ssd_bwd {tag} {name}: row {rel}"
        say(f"[kernels] ssd_intra_chunk_bwd {tag}: " + "; ".join(parts)
            + f" (atol {SSD_TOL[torch.float32]['atol']} x max, rtol "
            f"{SSD_TOL[torch.float32]['rtol']}, row < "
            f"{SSD_ROW_REL[torch.float32]:.0e}; a bf16 dxc + 2^-8)")
        if train:
            again = ssd_grads(x, dy, ds)
            same = [torch.equal(g, a) for g, a in zip(got, again)]
            say(f"[kernels] ssd_intra_chunk_bwd {tag}: a second call gives "
                f"bit-identical {', '.join(names)}: {same}")
            assert all(same), f"ssd_bwd {tag}: not deterministic"
            del again
        del x, dy, ds, got, want
        torch.cuda.empty_cache()
    say(f"[kernels] ssd_intra_chunk_bwd: {len(SSD_BWD_CASES)} cases through "
        f"SSDIntraChunk agree (one backward call each); largest row rel err: "
        + ", ".join(f"{str(dt)[6:]} {r:.3e}" for dt, r in worst.items())
        + f"; largest abs err at the training shapes {main_err:.3e}")
    x = ssd_inputs(*SSD_BWD_TRAIN, True, gen)
    dy, ds = ssd_cotangents(SSD_BWD_TRAIN, "both", gen)
    kernel = ssd_grads(x, dy, ds)
    with torch.no_grad():
        exact = ssd_intra_chunk_backward_reference(
            *(t.double() for t in x), dy.double(), ds.double())
        plain = ssd_intra_chunk_backward_reference(
            *(t.float() for t in x), dy, ds)
    say(f"[kernels] ssd_intra_chunk_bwd {SSD_BWD_TRAIN} x bf16: row rel err "
        f"against an f64 sum: " + "; ".join(
            f"{n} kernel {grad_row_rel_err(g, e):.3e}, plain f32 "
            f"{grad_row_rel_err(q, e):.3e}"
            for n, g, q, e in zip(names, kernel, plain, exact)))
    del x, dy, ds, kernel, exact, plain
    torch.cuda.empty_cache()
    ssd_intra_chunk.launches, ssd_intra_chunk.backward_launches = saved
    return main_err


def phase_card_vs_cpu() -> None:
    """The port on the card against itself on the CPU, f32 smoke configs:
    the engine's families through ``ServingEngine``, whisper and llava
    through prefill and 8 decode steps of the batched loop."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import Model
    from repro_torch.runtime import ServingEngine
    for arch in (WHISPER, LLAVA):
        batched_card_vs_cpu(arch)
    for arch in ("deepseek-7b", "gemma3-27b", "arctic-480b", LLAMA4, MAMBA2,
                 ZAMBA2):
        cfg = get_smoke(arch)
        cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        gpu = Model(cfg, device="cuda").load_state(cpu.state_dict())
        rng = np.random.default_rng(1)
        toks = rng.integers(0, cfg.vocab, size=(2, 24))
        lc, _ = cpu.prefill({"tokens": torch.as_tensor(toks)}, pad_to=32)
        lg, _ = gpu.prefill({"tokens": torch.as_tensor(toks, device="cuda")},
                            pad_to=32)
        rel = rel_err(lg, lc)
        assert rel < MODEL_REL, f"{arch}: prefill rel {rel}"
        engines = [ServingEngine(m, slots=2, max_len=48, device=m.device)
                   for m in (cpu, gpu)]
        prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 20, 11, 16)]
        done = []
        for eng in engines:
            for p in prompts:
                eng.submit(p, max_new=8)
            done.append([(c.id, c.tokens) for c in eng.run_until_drained()])
        assert done[0] == done[1], f"{arch}: tokens differ {done}"
        say(f"[card-vs-cpu] {arch} smoke f32: prefill logits rel {rel:.2e} "
            f"(< {MODEL_REL}); {len(done[1])} requests, greedy tokens equal")


def batched_card_vs_cpu(arch: str, steps: int = 8) -> None:
    """One smoke config through prefill and ``steps`` greedy decode steps
    on the CPU and on the card, from the same weights and batch
    (``serve.make_batch`` on the CPU, copied): the tokens must be equal and
    every step's logits within MODEL_REL."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import Model
    cfg = get_smoke(arch)
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device="cuda").load_state(cpu.state_dict())
    batch = serve.make_batch(cfg, 2, 24, "cpu")
    pad_to = serve.pad_len(cfg, 24, steps + 1)
    runs = []
    for model in (cpu, gpu):
        b = {k: v.to(model.device) for k, v in batch.items()}
        logits, cache = model.prefill(b, pad_to=pad_to)
        out = [logits.cpu()]
        for _ in range(steps):
            tok = torch.argmax(logits, dim=-1)[:, None]
            logits, cache = model.decode_step(tok, cache)
            out.append(logits.cpu())
        runs.append(out)
    rel = max(rel_err(g, c) for c, g in zip(*runs))
    toks = [[torch.argmax(x, -1).tolist() for x in run] for run in runs]
    assert rel < MODEL_REL, f"{arch}: logits rel {rel}"
    assert toks[0] == toks[1], f"{arch}: tokens differ {toks}"
    say(f"[card-vs-cpu] {arch} smoke f32: prefill and {steps} decode steps, "
        f"batch 2, logits rel {rel:.2e} (< {MODEL_REL}), greedy tokens "
        f"equal")


def side_inputs(cfg, b: int, gen: torch.Generator) -> dict:
    """What a batch of ``cfg`` carries besides tokens: frames (B, enc_len,
    d_model) for the encoder-decoder, patches (B, n_patches, 1024) for the
    VLM, 0.1 N(0, 1) in f32 from ``gen`` on its device, as
    ``launch/serve.py::make_batch`` draws them; nothing for the others."""
    from repro_torch.models.lm import PATCH_DIM
    shape = {"encdec": ("frames", (b, cfg.enc_len, cfg.d_model)),
             "vlm": ("patches", (b, cfg.n_patches, PATCH_DIM))}
    if cfg.family not in shape:
        return {}
    key, dims = shape[cfg.family]
    return {key: 0.1 * torch.randn(dims, generator=gen,
                                   device=gen.device)}


def train_state(cfg, dev, state: dict, opt):
    """A model of ``cfg`` on ``dev`` loaded with a copy of ``state``, and
    its training state {"params", "opt"} with zero moments, as
    ``Trainer.init_state`` gives it."""
    from repro_torch.models import Model
    model = Model(cfg, device=dev).load_state(
        {n: x.to(dev, copy=True) for n, x in state.items()})
    params = dict(model.named_parameters())
    return model, {"params": params, "opt": opt.init(params)}


def train_side_inputs(cfg, dev, state: dict, tcfg: dict, ckpt_dir: str):
    """For the encoder-decoder and the VLM, which ``Trainer`` refuses, what
    ``Trainer.run`` does for the others: ``tcfg``'s steps of
    ``make_train_step`` from ``state`` with Trainer's default AdamW
    schedule, tokens and labels from the synthetic corpus through the
    prefetching loader, frames or patches from a CPU generator seeded 3
    (copied to ``dev``), the checkpoint saved after the last step.  Returns
    (state, losses)."""
    from repro_torch.data import PrefetchingLoader, SyntheticCorpus
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.runtime import CheckpointManager
    steps, b, seq = tcfg["steps"], tcfg["batch"], tcfg["seq_len"]
    opt = AdamW(AdamWConfig(warmup_steps=max(steps // 10, 1),
                            total_steps=steps))
    model, st = train_state(cfg, dev, state, opt)
    step_fn = make_train_step(model, opt)
    gen = torch.Generator().manual_seed(3)
    loader = PrefetchingLoader(
        SyntheticCorpus(cfg.vocab, seq, seed=0), b, seq,
        to_device=lambda x: torch.as_tensor(x, dtype=torch.int64).to(dev))
    losses = []
    try:
        for _ in range(steps):
            batch = next(loader)
            batch.update({k: v.to(dev) for k, v in
                          side_inputs(cfg, b, gen).items()})
            st, metrics = step_fn(st, batch)
            losses.append(float(metrics["loss"]))
    finally:
        loader.close()
    CheckpointManager(ckpt_dir).save(steps - 1, st)
    return st, losses


def train_card_vs_cpu() -> None:
    """Training on the card against the same code on the CPU, f32 smoke
    configs from one initial state: the step-1 gradients leaf by leaf (with
    one backward call a layer of each kernel the family runs: flash, the
    grouped FFN, SSD; whisper's three attentions a decoder layer and one an
    encoder layer), the losses of 3 trainer steps (whisper and llava
    through ``make_train_step``, with frames or patches, as ``Trainer``
    refuses them), and the card's checkpoint restored on the CPU equal to
    the card's state."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import grouped_ffn
    from repro_torch.kernels.ssd import ssd_intra_chunk
    from repro_torch.models import Model
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.runtime import CheckpointManager, TrainConfig, Trainer
    from repro_torch.runtime.checkpoint import flatten_state
    for arch in TRAIN_SMOKE:
        cfg = get_smoke(arch)
        state = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0)).state_dict()
        toks = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 33))
        extra = side_inputs(cfg, 2, torch.Generator().manual_seed(2))
        grads = []
        bwd = (flash_attention.backward_launches,
               grouped_ffn.backward_launches,
               ssd_intra_chunk.backward_launches)
        for dev in ("cpu", "cuda"):
            model = Model(cfg, device=dev).load_state(
                {n: x.clone() for n, x in state.items()})
            loss, _ = model.train_loss(
                {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
                 "labels": torch.as_tensor(toks[:, 1:], device=dev),
                 **{k: v.to(dev) for k, v in extra.items()}})
            loss.backward()
            grads.append({n: p.grad for n, p in model.named_parameters()})
        # one backward call a layer on the card, none on the CPU
        moe_layers = cfg.n_layers if cfg.n_experts else 0
        mamba_layers = (cfg.n_layers if cfg.family in ("ssm", "hybrid")
                        else 0)
        assert (flash_attention.backward_launches,
                grouped_ffn.backward_launches,
                ssd_intra_chunk.backward_launches) == (
            bwd[0] + attention_layers(cfg), bwd[1] + moe_layers,
            bwd[2] + mamba_layers)
        g_rel = max(leaf_rel(grads[1][n], g) for n, g in grads[0].items())
        assert g_rel <= TRAIN_REL, f"{arch}: step-1 gradients {g_rel}"
        tcfg = dict(batch=2, seq_len=32, steps=3, ckpt_every=3, log_every=0)
        with tempfile.TemporaryDirectory() as d:
            if extra:
                runs = {dev: train_side_inputs(cfg, dev, state, tcfg,
                                               os.path.join(d, dev))
                        for dev in ("cpu", "cuda")}
                _, like = train_state(cfg, "cpu", state, AdamW(AdamWConfig()))
            else:
                runs = {dev: Trainer(cfg, TrainConfig(
                    **tcfg, ckpt_dir=os.path.join(d, dev)), device=dev,
                    params=state).run() for dev in ("cpu", "cuda")}
                like = Trainer(cfg, TrainConfig(**tcfg), device="cpu",
                               params=state).init_state()
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(runs["cuda"][1], runs["cpu"][1]))
            assert rel <= TRAIN_REL, f"{arch}: losses {runs}"
            _, step = CheckpointManager(os.path.join(d, "cuda")).restore(like)
            card, back = flatten_state(runs["cuda"][0]), flatten_state(like)
            assert step == 2 and list(card) == list(back)
            assert all(torch.equal(back[n], card[n].detach().cpu())
                       for n in card), f"{arch}: checkpoint differs"
        say(f"[card-vs-cpu] {arch} smoke f32 training: step-1 gradients "
            f"{len(grads[0])} leaves, largest ||card - cpu|| / ||cpu|| "
            f"{g_rel:.2e} (<= {TRAIN_REL}); 3 steps"
            + (f" (make_train_step, with {', '.join(extra)})" if extra
               else "") + ", losses "
            f"{[round(x, 6) for x in runs['cuda'][1]]}, largest rel "
            f"{rel:.2e} (<= {TRAIN_REL}); the card's checkpoint "
            f"({len(card)} leaves) restored on the CPU, equal")


def train_wide_bf16_vs_f32() -> dict:
    """deepseek-7b at full width, cut to WIDE_LAYERS layers, from one bf16
    initial state on the card, in bf16 and in f32 on one batch of
    TRAIN_BATCH x TRAIN_SEQ tokens (the training shape): the step-1 loss
    and every gradient leaf, then 3 ``Trainer`` steps whose losses must
    agree (the schedule puts the peak lr in step 1, as in phase 5b)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime import TrainConfig, Trainer
    cfg = get_config(TRAIN_ARCH).replace(n_layers=WIDE_LAYERS)
    cfgs = {"bf16": cfg, "f32": cfg.replace(param_dtype="float32",
                                           compute_dtype="float32")}
    state = Model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(0)).state_dict()
    gen = torch.Generator("cuda").manual_seed(12)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         device="cuda", generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grads, loss1, losses = {}, {}, {}
    for name, c in cfgs.items():
        model = Model(c, device="cuda").load_state(state)
        loss, _ = model.train_loss(batch)
        loss.backward()
        grads[name] = {n: p.grad for n, p in model.named_parameters()}
        loss1[name] = float(loss.detach())
        del model, loss
    rels = {n: leaf_rel(grads["bf16"][n], g) for n, g in grads["f32"].items()}
    worst = max(rels, key=rels.get)
    del grads
    tcfg = TrainConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=3,
                       log_every=0)
    for name, c in cfgs.items():
        gc.collect()
        torch.cuda.empty_cache()
        losses[name] = Trainer(c, tcfg, device="cuda", params=state).run()[1]
    gc.collect()
    torch.cuda.empty_cache()
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["bf16"], losses["f32"]))
    res = {"n_layers": WIDE_LAYERS, "step1_loss": loss1,
           "grad_rel": rels, "worst_leaf": worst, "losses": losses,
           "loss_rel": loss_rel}
    say(f"[card-vs-cpu] {TRAIN_ARCH} full width, {WIDE_LAYERS} layers, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, bf16 (wgmma backward, "
        f"wgmma forward with lse) against f32 (FMA kernels) on the card: "
        f"step-1 loss {loss1['bf16']:.6f} vs {loss1['f32']:.6f}; gradients "
        f"{len(rels)} leaves, worst ||bf16 - f32|| / ||f32|| {rels[worst]:.3e}"
        f" ({worst}; <= {WIDE_GRAD_REL}), median "
        f"{float(np.median(list(rels.values()))):.3e}; 3 steps' losses bf16 "
        + ", ".join(f"{x:.4f}" for x in losses["bf16"]) + ", f32 "
        + ", ".join(f"{x:.4f}" for x in losses["f32"])
        + f", largest rel {loss_rel:.3e} (<= {WIDE_LOSS_REL})")
    assert rels[worst] <= WIDE_GRAD_REL, f"bf16 vs f32 gradients {rels}"
    assert loss_rel <= WIDE_LOSS_REL, f"bf16 vs f32 losses {losses}"
    return res


def attention_layers(cfg) -> int:
    """The flash attentions a full forward (a prefill) runs: one a layer,
    none (ssm), the shared block once per ``attn_every`` layers (hybrid), or
    for the encoder-decoder one an encoder layer and two a decoder layer
    (its causal self-attention and its cross-attention)."""
    return {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
            "encdec": cfg.enc_layers + 2 * cfg.n_layers
            }.get(cfg.family, cfg.n_layers)


def build_model(cfg, tag: str):
    """``cfg`` at full width on the card, weights drawn from seed 0; says
    its widths and size."""
    from repro_torch.models import Model
    gc.collect()                 # an earlier path's model is gone for good
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(f"{tag} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{widths(cfg)}, vocab {cfg.vocab}, {cfg.param_dtype}: "
        f"{n_params:,} params ({model.cfg.param_counts()['total']:.4g} "
        f"counted), init {time.perf_counter() - t0:.1f} s")
    return model


def widths(cfg) -> str:
    """``cfg``'s widths by family: the mamba layers', the attention and
    MLP's (with the experts), the hybrid's shared block, the encoder, the
    patches."""
    moe = (f", {cfg.n_experts} experts top-{cfg.top_k}, shared expert "
           f"{cfg.shared_expert_ff}" if cfg.n_experts else "")
    return ", ".join(
        ([f"d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads x "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv "
          f"{cfg.ssm_conv}, chunk {cfg.ssm_chunk}"]
         if cfg.family in ("ssm", "hybrid") else [])
        + ([f"{cfg.n_heads} heads x {cfg.head_dim} ({cfg.n_kv_heads} kv), "
            f"d_ff {cfg.d_ff} {cfg.mlp_act}{moe}"]
           if attention_layers(cfg) else [])
        + ([f"shared attention + MLP block every {cfg.attn_every} layers"]
           if cfg.family == "hybrid" else [])
        + ([f"{cfg.enc_layers} encoder layers over {cfg.enc_len} frames"]
           if cfg.family == "encdec" else [])
        + ([f"{cfg.n_patches} image patches"] if cfg.family == "vlm"
           else []))


def time_calls(model) -> tuple[list, list]:
    """Time each of the model's prefill and decode_step calls (host clock,
    synchronised before and after) into the two lists returned; prefill
    logits must be finite.  ``del model.prefill, model.decode_step`` goes
    back to the class's methods: bound methods stored on the instance
    would make a reference cycle that keeps the weights on the card."""
    prefill_s, decode_s = [], []
    prefill, decode = model.prefill, model.decode_step

    def timed_prefill(batch, pad_to=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = prefill(batch, pad_to=pad_to)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t)
        assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
        return logits, cache

    def timed_decode(tokens, cache):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode(tokens, cache)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t)
        return out

    model.prefill, model.decode_step = timed_prefill, timed_decode
    return prefill_s, decode_s


def zero_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import grouped_ffn
    from repro_torch.kernels.moe_gmm.kernel import grouped_ffn_bwd_cuda
    from repro_torch.kernels.ssd import ssd_intra_chunk
    flash_attention.launches = grouped_ffn.launches = 0
    flash_attention.backward_launches = ssd_intra_chunk.launches = 0
    grouped_ffn.backward_launches = ssd_intra_chunk.backward_launches = 0
    grouped_ffn_bwd_cuda.bodies = {}


def read_counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import grouped_ffn
    from repro_torch.kernels.ssd import ssd_intra_chunk
    return {"flash_attn_fwd": flash_attention.launches,
            "flash_attn_bwd": flash_attention.backward_launches,
            "moe_gmm": grouped_ffn.launches,
            "moe_gmm_bwd": grouped_ffn.backward_launches,
            "ssd_intra_chunk": ssd_intra_chunk.launches,
            "ssd_intra_chunk_bwd": ssd_intra_chunk.backward_launches}


def serve_record(cfg, card, prompt_lens, prefill_s, decode_s, n_tok, wall,
                 launches) -> dict:
    return {
        "card": card,
        "arch": cfg.name,
        "n_layers": cfg.n_layers,
        "prompt_lens": [int(n) for n in prompt_lens],
        "prefill_ms_per_request": 1e3 * sum(prefill_s) / len(prefill_s),
        "prefill_ms": [1e3 * s for s in prefill_s],
        "decode_steps": len(decode_s),
        "decode_ms_per_step": 1e3 * sum(decode_s) / len(decode_s),
        "generated_tokens": n_tok,
        "drain_s": wall,
        "tokens_per_s": n_tok / wall,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
    }


def phase_serve(cfg, card: str) -> dict:
    """One main path: ``cfg`` at full width through ServingEngine, with the
    kernels' launch counts set to 0 just before and read just after."""
    from repro_torch.runtime import ServingEngine

    tag = f"[serve {cfg.name}]"
    mamba = cfg.family in ("ssm", "hybrid")
    n_attn = attention_layers(cfg)
    model = build_model(cfg, tag)
    prefill_s, decode_s = time_calls(model)
    engine = ServingEngine(model, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    prompts = serve_prompts(cfg.vocab)
    ids = [engine.submit(p, max_new=SERVE_NEW) for p in prompts]

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    assert sorted(c.id for c in done) == sorted(ids), "not all completed"
    assert all(len(c.tokens) == SERVE_NEW for c in done), "wrong token counts"
    assert all(0 <= t < cfg.vocab for c in done for t in c.tokens)
    assert len(prefill_s) == SERVE_REQUESTS
    n_pre = len(prefill_s)
    want = {"flash_attn_fwd": n_attn * n_pre, "flash_attn_bwd": 0,
            "moe_gmm": cfg.n_layers * (n_pre + len(decode_s))
            if cfg.n_experts else 0, "moe_gmm_bwd": 0,
            "ssd_intra_chunk": cfg.n_layers * n_pre if mamba else 0,
            "ssd_intra_chunk_bwd": 0}
    assert launches == want, f"launches {launches} != {want}"
    n_tok = sum(len(c.tokens) for c in done)
    res = serve_record(cfg, card, [len(p) for p in prompts], prefill_s,
                       decode_s, n_tok, wall, launches)
    by_id = {c.id: c.tokens for c in done}
    res["tokens"] = [by_id[i] for i in ids]     # phase 9 holds them
    say(f"{tag} {len(done)} requests (prompts {res['prompt_lens']}, "
        f"{SERVE_NEW} new tokens each), slots {SERVE_SLOTS}, max_len "
        f"{SERVE_MAX_LEN}")
    say(f"{tag} prefill {res['prefill_ms_per_request']:.2f} ms/request, "
        f"decode {res['decode_ms_per_step']:.2f} ms/step over "
        f"{len(decode_s)} steps, {res['tokens_per_s']:.1f} generated "
        f"tokens/s ({n_tok} in {wall:.2f} s), max memory allocated "
        f"{res['max_memory_allocated_gb']:.2f} GB [{card}]")
    say(f"{tag} launches {launches}: "
        + "; ".join(([f"flash = {n_attn} attention layers x {n_pre} "
                      f"prefills"] if n_attn else ["no attention"])
                    + ([f"ssd_intra_chunk = {cfg.n_layers} mamba layers x "
                        f"{n_pre} prefills"] if mamba else []))
        + (f"; moe_gmm = {cfg.n_layers} layers x ({n_pre} "
           f"prefills + {len(decode_s)} decode steps)" if cfg.n_experts
           else ""))
    del model.prefill, model.decode_step
    res["profile"] = phase_profile(model, card)
    return res


def phase_serve_batched(cfg, card: str) -> dict:
    """One main path that the engine does not serve (its prefill takes
    frames or patches besides tokens): ``cfg`` at full width through the
    batched loop of ``launch/serve.py`` (``make_batch``, ``generate``):
    BATCH prompts of BATCH_PROMPT tokens, SERVE_NEW new tokens each, with
    the kernels' launch counts set to 0 just before and read just after."""
    from repro_torch.launch import serve

    tag = f"[serve {cfg.name}]"
    model = build_model(cfg, tag)
    prefill_s, decode_s = time_calls(model)
    batch = serve.make_batch(cfg, BATCH, BATCH_PROMPT, "cuda")

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = serve.generate(model, batch, SERVE_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()

    assert toks.shape == (BATCH, SERVE_NEW), toks.shape
    assert bool(((toks >= 0) & (toks < cfg.vocab)).all())
    assert len(prefill_s) == 1 and len(decode_s) == SERVE_NEW - 1
    want = {"flash_attn_fwd": attention_layers(cfg), "flash_attn_bwd": 0,
            "moe_gmm": 0, "moe_gmm_bwd": 0, "ssd_intra_chunk": 0,
            "ssd_intra_chunk_bwd": 0}
    assert launches == want, f"launches {launches} != {want}"
    res = serve_record(cfg, card, [BATCH_PROMPT] * BATCH, prefill_s,
                       decode_s, toks.numel(), wall, launches)
    extra = (f"{cfg.enc_len} frames each" if cfg.family == "encdec" else
             f"after {cfg.n_patches} patches each")
    say(f"{tag} one batch of {BATCH} prompts of {BATCH_PROMPT} tokens "
        f"({extra}), {SERVE_NEW} new tokens each, through launch/serve.py")
    say(f"{tag} prefill {res['prefill_ms'][0]:.2f} ms (the batch), decode "
        f"{res['decode_ms_per_step']:.2f} ms/step over {len(decode_s)} "
        f"steps, {res['tokens_per_s']:.1f} generated tokens/s "
        f"({toks.numel()} in {wall:.2f} s), max memory allocated "
        f"{res['max_memory_allocated_gb']:.2f} GB [{card}]")
    say(f"{tag} launches {launches}: flash = {attention_layers(cfg)} "
        + (f"attentions ({cfg.enc_layers} encoder layers, {cfg.n_layers} "
           f"decoder layers x 2: self and cross)" if cfg.family == "encdec"
           else "layers") + " x 1 prefill")
    del model.prefill, model.decode_step
    if cfg.family == "encdec":
        res["prefill_peak_gb"] = prefill_peak_gb(model, batch, card)
    return res


def prefill_peak_gb(model, batch, card: str) -> dict:
    """Peak device memory of one prefill of ``batch``, weights included,
    with the non-causal attentions (whisper's encoder and cross-attention)
    on the flash kernel, and again on its plain version (f32 scores, the
    spelling the port's encoder and cross-attention had before they moved to
    flash); the launches of these two calls are not counted."""
    from repro_torch.kernels.flash_attention import (attention_reference,
                                                     flash_attention)
    from repro_torch.models import attention
    saved = flash_attention.launches
    flash = attention.flash_attention

    def plain_non_causal(q, k, v, causal=True, window=0, scale=None):
        if causal:
            return flash(q, k, v, causal=True, window=window, scale=scale)
        return attention_reference(q, k, v, causal=False, window=window,
                                   scale=scale)

    out = {}
    for key in ("kernel", "plain"):
        attention.flash_attention = flash if key == "kernel" else \
            plain_non_causal
        try:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            model.prefill(batch, pad_to=BATCH_PROMPT + SERVE_NEW)
            torch.cuda.synchronize()
            out[key] = torch.cuda.max_memory_allocated() / 1e9
        finally:
            attention.flash_attention = flash
    flash_attention.launches = saved
    say(f"[serve {model.cfg.name}] one prefill's peak memory, weights "
        f"included: {out['kernel']:.3f} GB with the encoder and "
        f"cross-attention on flash, {out['plain']:.3f} GB on the plain "
        f"version (f32 scores) [{card}]")
    return out


def profile_region(fn, label: str, card: str, top: int = 12,
                   groups: dict | None = None) -> dict:
    """Run ``fn`` under torch.profiler; device busy share and top kernels,
    and the device time of each of ``groups`` (label -> kernel name
    substrings; the first that matches takes a kernel, the rest is
    "other")."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                     # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "busy_share": busy_us / wall_us if wall_us else 0.0,
           "top": [(name[:90], us / 1e3) for name, us in ranked[:top]]}
    if groups:
        out["groups"] = dict.fromkeys([*groups, "other"], 0.0)
        for name, us in ranked:
            key = next((g for g, subs in groups.items()
                        if any(x in name for x in subs)), "other")
            out["groups"][key] += us / 1e3
    if busy_us == 0:
        say(f"[profile] {label}: the profiler saw no device time; "
            f"device share not measured")
        return out
    say(f"[profile] {label}: wall {out['wall_ms']:.2f} ms, device busy "
        f"{out['device_busy_ms']:.2f} ms ({100 * out['busy_share']:.1f}%) "
        f"[{card}]")
    for name, ms in out["top"]:
        say(f"[profile]   {ms:9.3f} ms  {100 * ms * 1e3 / busy_us:5.1f}%  "
            f"{name}")
    if groups:
        say(f"[profile]   {label}, by kind: " + "; ".join(
            f"{g} {ms:.3f} ms ({100 * ms * 1e3 / busy_us:.1f}%)"
            for g, ms in out["groups"].items()))
    return out


def phase_profile(model, card: str) -> dict:
    """Where a full-width prefill (512 tokens) and a decode step (4 slots,
    512 cached tokens) spend their time."""
    cfg = model.cfg
    gen = torch.Generator("cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (1, 512), device="cuda",
                           generator=gen)
    cache = model.init_decode_cache(4, 1024)
    cache["pos"].fill_(512)
    tok = torch.randint(0, cfg.vocab, (4, 1), device="cuda", generator=gen)

    def decode():
        cache["pos"].fill_(512)
        model.decode_step(tok, cache)

    return {
        "prefill_512": profile_region(
            lambda: model.prefill({"tokens": prompt}, pad_to=1024),
            f"{cfg.name}: prefill of 512 tokens", card),
        "decode_b4": profile_region(decode, f"{cfg.name}: decode step, 4 "
                                    f"slots", card),
    }


def phase_train(card: str, cfg) -> dict:
    """A training path: ``Trainer`` on ``cfg`` (bf16, remat "full"; AdamW
    with bf16 moments, the one departure from the reference's defaults),
    TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens from the synthetic
    corpus, with every kernel's launch count set to 0 just before and read
    just after; then one profiled step, and the optimizer's update alone,
    timed with CUDA events.  5b runs deepseek-7b at full width and depth,
    5c llama4-scout at its full widths cut to MOE_TRAIN_LAYERS layers, 5d
    mamba2-780m and 5e zamba2-2.7b at full width and depth."""
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig, Trainer
    tag = f"[train {cfg.name}]"
    moe = bool(cfg.n_experts)
    n_attn = attention_layers(cfg)
    n_mamba = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    gc.collect()                 # the earlier paths' models are gone
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, TrainConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                       steps=TRAIN_STEPS, log_every=0),
                      AdamWConfig(warmup_steps=max(TRAIN_STEPS // 10, 1),
                                  total_steps=TRAIN_STEPS,
                                  moment_dtype="bfloat16"))
    zero_counts()
    t0 = time.perf_counter()
    state, losses = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in state["params"].values())
    # the forward and remat's recompute launch the forwards twice a layer
    want = {"flash_attn_fwd": 2 * n_attn * TRAIN_STEPS,
            "flash_attn_bwd": n_attn * TRAIN_STEPS,
            "moe_gmm": 2 * cfg.n_layers * TRAIN_STEPS if moe else 0,
            "moe_gmm_bwd": cfg.n_layers * TRAIN_STEPS if moe else 0,
            "ssd_intra_chunk": 2 * n_mamba * TRAIN_STEPS,
            "ssd_intra_chunk_bwd": n_mamba * TRAIN_STEPS}
    assert launches == want, f"launches {launches} != {want}"
    from repro_torch.kernels.moe_gmm.kernel import grouped_ffn_bwd_cuda
    # the body each launch named to the kernel, which runs it or fails
    bodies = dict(grouped_ffn_bwd_cuda.bodies)
    if moe:      # bf16 training: every backward launch on the wgmma body
        assert bodies == {"wgmma": want["moe_gmm_bwd"]}, bodies
    norms = [m["grad_norm"] for m in trainer.metrics]
    assert len(losses) == TRAIN_STEPS and all(
        np.isfinite(x) for x in losses + norms), (losses, norms)
    assert peak_gb * 1e9 < torch.cuda.get_device_properties(0).total_memory
    step_s = trainer.step_seconds
    ms = 1e3 * float(np.median(step_s[-5:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res = {"card": card, "arch": cfg.name, "n_layers": cfg.n_layers,
           "path": "train", "params": n_params, "batch": TRAIN_BATCH,
           "seq_len": TRAIN_SEQ, "remat": cfg.remat,
           "moment_dtype": "bfloat16", "steps": TRAIN_STEPS,
           "step_ms": [1e3 * x for x in step_s],
           "ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
           "losses": losses, "grad_norms": norms,
           "aux": [m["aux"] for m in trainer.metrics],
           "lr": [m["lr"] for m in trainer.metrics], "run_s": wall,
           "max_memory_allocated_gb": peak_gb, "launches": launches}
    if moe:
        res["moe_gmm_bwd_bodies"] = bodies
    say(f"{tag} {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{widths(cfg)}, vocab {cfg.vocab}, {cfg.param_dtype}, remat "
        f"{cfg.remat}: {n_params:,} params; AdamW moments bf16; "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens")
    say(f"{tag} {ms:.2f} ms/step (median of the last 5; steps "
        + ", ".join(f"{x:.1f}" for x in res["step_ms"]) + f" ms), "
        f"{res['tokens_per_s']:.1f} tokens/s, run {wall:.1f} s with init, "
        f"max memory allocated {peak_gb:.2f} GB [{card}]")
    say(f"{tag} losses " + ", ".join(f"{x:.4f}" for x in losses)
        + (("; aux " + ", ".join(f"{x:.4f}" for x in res["aux"]))
           if moe else "")
        + "; grad norms " + ", ".join(f"{x:.4f}" for x in norms)
        + "; lr " + ", ".join(f"{x:.3e}" for x in res["lr"]))
    say(f"{tag} launches {launches}: each forward = its layers x 2 (the "
        f"forward and remat's recompute) x {TRAIN_STEPS} steps, each "
        f"backward = its layers x {TRAIN_STEPS}; flash {n_attn} attention "
        f"layers, ssd {n_mamba} mamba layers"
        + (f"; moe_gmm {cfg.n_layers} layers, moe_gmm_bwd by body {bodies}"
           if moe else ""))
    gen = torch.Generator("cuda").manual_seed(10)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         device="cuda", generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    res["profile"] = profile_region(
        lambda: trainer.step_fn(state, batch), f"{cfg.name}: one training "
        f"step of {TRAIN_BATCH} x {TRAIN_SEQ} tokens", card,
        groups=TRAIN_GROUPS)
    # bf16 training: the profile sees only the wgmma body's kernels
    fma_ms = res["profile"].get("groups", {}).get(
        "moe_gmm backward, fma body", 0.0)
    assert fma_ms == 0.0, f"{tag} the fma body ran for {fma_ms} ms"
    res["adamw_ms"] = adamw_alone(trainer.opt, state, tag, ms, card)
    if cfg.name in CARD_COUNT:
        res["card_count"] = card_count(trainer.step_fn, state, cfg)
    del trainer, state, batch, toks
    gc.collect()
    torch.cuda.empty_cache()
    return res


# a training step's device time by kind (profile_region's groups).  The
# grouped FFN's kernels come first: "gemm" of the matrix products would take
# its forward's gemm_persistent; its scan counts with the forward
TRAIN_GROUPS = {"ssd backward": ("ssd_bwd_", "BwdArgs"),
                "ssd forward": ("ssd_chunk_kernel", "ssd_cb_kernel"),
                "moe_gmm forward": ("gemm_persistent", "reduce_splits",
                                    "scan_rows"),
                "moe_gmm backward": ("HiddenPass", "DxPass", "WeightPass"),
                "moe_gmm backward, fma body": ("hidden_pass", "dx_pass",
                                               "dw_pass"),
                "matrix products": ("nvjet", "gemm", "xmma", "cutlass"),
                "flash forward": ("flash_attn_fwd",),
                "flash backward": ("flash_attn_bwd",)}


# phase 7b: the training paths whose step is counted on the card as well
CARD_COUNT = ("deepseek-7b", LLAMA4, MAMBA2)


def card_count(step_fn, state: dict, cfg) -> dict:
    """One more training step of TRAIN_BATCH x TRAIN_SEQ tokens, after the
    timed and profiled ones, under ``roofline.counting.Counter`` on the
    card: FLOPs and bytes by kind, kernel calls (phase 7 holds them equal to
    the meta dry run's count of the same step)."""
    from repro_torch.roofline import Counter
    gen = torch.Generator("cuda").manual_seed(12)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         device="cuda", generator=gen)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    with Counter("cuda") as counter:
        step_fn(state, batch)
    torch.cuda.synchronize()
    return counter.summary()


def adamw_alone(opt, state: dict, tag: str, step_ms: float,
                card: str) -> float:
    """The optimizer layer alone: one update of every leaf of ``state``,
    timed with CUDA events (its time does not depend on the gradients'
    values)."""
    params = state["params"]
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    ms = time_ms(lambda: opt.update(grads, state["opt"], params), 2,
                 warmup=1)
    n_params = sum(p.numel() for p in params.values())
    say(f"{tag} AdamW's update of all {n_params:,} parameters alone: "
        f"{ms:.2f} ms, {100 * ms / step_ms:.1f}% of the step's "
        f"{step_ms:.2f} ms [{card}]")
    return ms


def phase_train_batched(card: str, cfg) -> dict:
    """5f, 5g: a training path through ``launch/steps.make_train_step``
    and AdamW (bf16 moments, as 5b-5e), for the families whose batches
    carry frames or patches besides tokens: ``cfg`` at full width and depth
    (bf16, remat "full"), TRAIN_STEPS steps of BATCHED_TRAIN's batch,
    tokens and labels from the synthetic corpus through the prefetching
    loader, frames or patches 0.1 N(0, 1) from a seeded generator
    (``side_inputs``), every kernel's launch count set to 0 just before and
    read just after; ms per step (host clock from the step's call until its
    metrics are read, as ``Trainer.step_seconds``), then one profiled step
    and the optimizer's update alone."""
    from repro_torch.data import PrefetchingLoader, SyntheticCorpus
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamW, AdamWConfig
    tag = f"[train {cfg.name}]"
    b, seq = BATCHED_TRAIN[cfg.name]
    n_attn = attention_layers(cfg)
    positions = b * (seq + (cfg.n_patches if cfg.family == "vlm" else 0))
    gc.collect()                 # the earlier paths' models are gone
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(0))
    opt = AdamW(AdamWConfig(warmup_steps=max(TRAIN_STEPS // 10, 1),
                            total_steps=TRAIN_STEPS, moment_dtype="bfloat16"))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    step_fn = make_train_step(model, opt)
    gen = torch.Generator("cuda").manual_seed(1)
    loader = PrefetchingLoader(
        SyntheticCorpus(cfg.vocab, seq, seed=0), b, seq,
        to_device=lambda x: torch.as_tensor(x, dtype=torch.int64).to("cuda"))
    metrics, step_s = [], []
    try:
        for _ in range(TRAIN_STEPS):
            batch = {**next(loader), **side_inputs(cfg, b, gen)}
            t = time.perf_counter()
            state, met = step_fn(state, batch)
            metrics.append({k: float(v) for k, v in met.items()})
            step_s.append(time.perf_counter() - t)
    finally:
        loader.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(p.numel() for p in params.values())
    # the forward and remat's recompute launch the forwards twice each
    want = {"flash_attn_fwd": 2 * n_attn * TRAIN_STEPS,
            "flash_attn_bwd": n_attn * TRAIN_STEPS, "moe_gmm": 0,
            "moe_gmm_bwd": 0, "ssd_intra_chunk": 0, "ssd_intra_chunk_bwd": 0}
    assert launches == want, f"launches {launches} != {want}"
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    assert all(np.isfinite(x) for x in losses + norms), (losses, norms)
    assert peak_gb * 1e9 < torch.cuda.get_device_properties(0).total_memory
    ms = 1e3 * float(np.median(step_s[-5:]))
    res = {"card": card, "arch": cfg.name, "n_layers": cfg.n_layers,
           "path": "train", "params": n_params, "batch": b,
           "seq_len": seq, "positions": positions, "remat": cfg.remat,
           "moment_dtype": "bfloat16", "steps": TRAIN_STEPS,
           "step_ms": [1e3 * x for x in step_s], "ms_per_step": ms,
           "tokens_per_s": b * seq / ms * 1e3,
           "positions_per_s": positions / ms * 1e3, "losses": losses,
           "grad_norms": norms, "lr": [m["lr"] for m in metrics],
           "run_s": wall, "max_memory_allocated_gb": peak_gb,
           "launches": launches}
    inputs = (f"{cfg.enc_len} frames + {seq} decoder tokens"
              if cfg.family == "encdec" else
              f"{cfg.n_patches} patches + {seq} tokens")
    say(f"{tag} {widths(cfg)}; {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.param_dtype}, remat "
        f"{cfg.remat}: {n_params:,} params; AdamW moments bf16; "
        f"{TRAIN_STEPS} steps of {b} x ({inputs}) through make_train_step")
    say(f"{tag} {ms:.2f} ms/step (median of the last 5; steps "
        + ", ".join(f"{x:.1f}" for x in res["step_ms"]) + f" ms), "
        f"{res['tokens_per_s']:.1f} trained (label) tokens/s"
        + (f", {res['positions_per_s']:.1f} positions/s"
           if cfg.family == "vlm" else "")
        + f", run {wall:.1f} s with init, max memory allocated "
        f"{peak_gb:.2f} GB [{card}]")
    say(f"{tag} losses " + ", ".join(f"{x:.4f}" for x in losses)
        + "; grad norms " + ", ".join(f"{x:.4f}" for x in norms)
        + "; lr " + ", ".join(f"{x:.3e}" for x in res["lr"]))
    say(f"{tag} launches {launches}: flash forward = {n_attn} attentions x "
        f"2 (the forward and remat's recompute) x {TRAIN_STEPS} steps, "
        f"backward = {n_attn} x {TRAIN_STEPS}")
    toks = torch.randint(0, cfg.vocab, (b, seq + 1), device="cuda",
                         generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             **side_inputs(cfg, b, gen)}
    res["profile"] = profile_region(
        lambda: step_fn(state, batch), f"{cfg.name}: one training step of "
        f"{b} x ({inputs})", card, groups=TRAIN_GROUPS)
    res["adamw_ms"] = adamw_alone(opt, state, tag, ms, card)
    del model, opt, params, state, step_fn, batch, toks
    gc.collect()
    torch.cuda.empty_cache()
    return res


def graph_ms(fn, iters: int = 20) -> float:
    """Time of ``fn``'s launches replayed from a CUDA graph: the device's
    time for one call, without the host's cost of issuing it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                 # warm: build, allocate
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, iters)
    del graph
    return ms


def device_ms(fn, iters: int = 20, spin_cycles: int = 400_000_000) -> float:
    """The device's time for one call of ``fn`` without the host's cost of
    issuing it, for calls a CUDA graph cannot hold (an autograd backward):
    the card spins ``spin_cycles`` clocks (about 0.2 s) while the host
    queues ``iters`` calls behind it, so the events between them time only
    the device's work (if a call waited for the card, the host's cost
    would show again)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_served_shape(arch: str = "deepseek-7b") -> tuple:
    """(B, S, H, K, hd, window) of ``arch``'s longest served prompt."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    s = max(len(p) for p in serve_prompts(cfg.vocab))
    return (1, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 0)


def phase_timing(card: str) -> dict:
    """Flash attention in bf16: causal at (1, 2048, 32, 128), at deepseek's
    longest served prefill and at zamba2's (hd 80, the mma.sync body);
    non-causal at whisper's encoder at its training batch (8, 1500, 16, 64):
    three rounds each, in turns with SDPA, medians kept, the card's clocks
    read before and after."""
    from repro_torch.kernels.flash_attention import (attention_reference,
                                                     flash_attention)
    gen = torch.Generator("cuda").manual_seed(2)
    saved = flash_attention.launches
    out = {}
    for key, shape, causal in (
            ("timed", TIMED, True), ("served", flash_served_shape(), True),
            ("served_hd80", flash_served_shape(ZAMBA2), True),
            ("whisper_encoder", (*BWD_TIMED["whisper encoder"][:5], 0),
             False)):
        b, s, h, k, hd, window = shape
        mode = "causal" if causal else "non-causal"
        q, kk, v = qkv(b, s, s, h, k, hd, torch.bfloat16, gen)
        # SDPA takes (B, H, S, hd): transposed once, outside the timed call
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kk, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=h != k)

        say(f"[timing] flash_attn_fwd {shape[:5]}: clocks before ({CLOCKS}) "
            f"{card_line(CLOCKS)}")
        kernel_r, library_r = [], []
        for _ in range(3):
            kernel_r.append(time_ms(lambda: flash_attention(
                q, kk, v, causal=causal), 20))
            library_r.append(time_ms(sdpa, 20))
        say(f"[timing] flash_attn_fwd {shape[:5]}: clocks after "
            f"{card_line(CLOCKS)}; kernel rounds "
            f"{', '.join(f'{t:.4f}' for t in kernel_r)} ms, sdpa rounds "
            f"{', '.join(f'{t:.4f}' for t in library_r)} ms")
        kernel_ms, library_ms = sorted(kernel_r)[1], sorted(library_r)[1]
        device_ms = graph_ms(lambda: flash_attention(q, kk, v,
                                                     causal=causal))
        plain_ms = time_ms(lambda: attention_reference(q, kk, v,
                                                       causal=causal), 5)
        flops, nbytes = kernel_model.flash_fwd(b, s, s, h, k, hd, causal)
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        res = {"shape": list(shape[:5]), "causal": causal, "ms": kernel_ms,
               "graph_ms": device_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "flops": flops, "bytes": nbytes}
        say(f"[timing] flash_attn_fwd {shape[:5]} bf16 {mode}: kernel "
            f"{kernel_ms:.4f} ms (median; replayed from a CUDA graph "
            f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, sdpa "
            f"(yardstick) {library_ms:.4f} ms, kernel / sdpa "
            f"{kernel_ms / library_ms:.3f}; bound {bound_ms:.4f} ms by "
            f"{res['bound_by']} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} "
            f"MB); {flops / kernel_ms / 1e9:.2f} TFLOP/s achieved, "
            f"{100 * bound_ms / kernel_ms:.1f}% of bound [{card}]")
        out[key] = res
        del q, kk, v, qt, kt, vt
    flash_attention.launches = saved     # comparisons do not count
    return out


def phase_timing_bwd(card: str) -> dict:
    """The flash backward at BWD_TIMED, bf16: a call of its binding (its
    launches; the checks of ``FlashAttention`` stay outside the timed call)
    with the wgmma body, at hd 128 with the mma.sync body too (asked for by
    name, as no other phase does), and autograd's backward of SDPA (the
    yardstick, never called by the port), in three rounds in turns, medians
    kept; each body's call replayed from a CUDA graph; the plain backward
    at the training shape.  Returns the training shape's wgmma numbers,
    with the mma.sync body's and the other shapes' beside them."""
    from repro_torch.kernels.flash_attention import \
        attention_backward_reference
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    gen = torch.Generator("cuda").manual_seed(11)
    out = {}
    for key, shape in BWD_TIMED.items():
        b, s, h, k, hd, causal = shape
        bodies = ("wgmma", "mma") if hd == 128 else ("wgmma",)
        scale = hd ** -0.5
        q, kk, v = qkv(b, s, s, h, k, hd, torch.bfloat16, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        o, lse = flash_attention_cuda(q, kk, v, causal, 0, scale,
                                      with_lse=True)

        def kernel(body=None):
            return flash_attention_bwd_cuda(q, kk, v, o, lse, do, causal, 0,
                                            scale, body=body)

        # SDPA takes (B, H, S, hd): transposed once, outside the timed call
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, kk, v))
        ot = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=h != k)
        dot = do.transpose(1, 2).contiguous()

        def library():
            return torch.autograd.grad(ot, (qt, kt, vt), dot,
                                       retain_graph=True)

        tag = f"flash_attn_bwd {shape[:5]}"
        mode = "causal" if causal else "non-causal"
        for _ in range(5):   # SDPA's backward ran slow in its first rounds
            for body in bodies:
                kernel(body)
            library()
        say(f"[timing] {tag}: clocks before ({CLOCKS}) {card_line(CLOCKS)}")
        rounds = {n: [] for n in (*bodies, "sdpa")}
        for _ in range(3):
            for body in bodies:
                rounds[body].append(time_ms(lambda: kernel(body), 10))
            rounds["sdpa"].append(time_ms(library, 10))
        say(f"[timing] {tag}: clocks after {card_line(CLOCKS)}; rounds "
            + "; ".join(f"{n} " + ", ".join(f"{t:.4f}" for t in r) + " ms"
                        for n, r in rounds.items()))
        med = {n: sorted(r)[1] for n, r in rounds.items()}
        graph = {body: graph_ms(lambda: kernel(body)) for body in bodies}
        flops, nbytes = kernel_model.flash_bwd(b, s, s, h, k, hd, causal)
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        res = {"shape": list(shape[:5]), "causal": causal,
               "ms": med["wgmma"], "graph_ms": graph["wgmma"],
               "library_ms": med["sdpa"], "bound_ms": bound,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "flops": flops, "bytes": nbytes}
        if "mma" in bodies:
            res["mma"] = {"ms": med["mma"], "graph_ms": graph["mma"]}
        if key == "train":
            res["plain_ms"] = time_ms(lambda: attention_backward_reference(
                q, kk, v, o, lse, do), 3)
        for body in bodies:
            say(f"[timing] {tag} bf16 {mode}, {body} body: "
                f"{med[body]:.4f} ms (median; replayed from a CUDA graph "
                f"{graph[body]:.4f} ms), sdpa backward (yardstick) "
                f"{med['sdpa']:.4f} ms, {body} / sdpa "
                f"{med[body] / med['sdpa']:.3f} (graph "
                f"{graph[body] / med['sdpa']:.3f}); bound {bound:.4f} ms by "
                f"{res['bound_by']} ({flops / 1e9:.2f} GFLOP, "
                f"{nbytes / 1e6:.2f} MB; the other bound "
                f"{min(t_ops, t_bytes):.4f} ms); "
                f"{flops / graph[body] / 1e9:.2f} TFLOP/s from the graph, "
                f"{100 * bound / graph[body]:.1f}% "
                f"of bound [{card}]")
        if "plain_ms" in res:
            say(f"[timing] {tag}: plain backward {res['plain_ms']:.4f} ms")
        out[key] = res
        del q, kk, v, do, o, lse, qt, kt, vt, ot, dot
        torch.cuda.empty_cache()
    res = dict(out["train"])
    res["by_shape"] = out
    return res


def flash_bwd_only(card: str) -> int:
    """``--flash-bwd-only``: the flash kernels built, the backward's
    registers and spills, its checks (phase 3's backward part) and its
    timings (phase 6's backward part); one JSON line."""
    from repro_torch.kernels import _build
    names = ["flash_attn_fwd", "flash_attn_bwd"]
    _build.build_all(names)
    lines = [ln.strip() for ln in _build.build_log("flash_attn_bwd")
             .splitlines() if "registers" in ln or "spill" in ln
             or "entry function" in ln or "warning" in ln or "Loss" in ln]
    for ln in lines:
        say(f"[build] flash_attn_bwd: {ln}")
    wgmma_bwd_report(lines)
    err = phase_flash_backward()
    timing = phase_timing_bwd(card)
    say(json.dumps({"max_abs_err": err, "flash_bwd_timing": timing}))
    return 0


def moe_bwd_only(card: str, other: bool) -> int:
    """``--moe-bwd-only``: the grouped FFN's kernels built, the backward's
    registers and spills, its checks (phase 3's backward part) and its
    timings (phase 6's); one JSON line.  ``other``: the kernels are another
    checkout's (``--src``), whose wgmma body, if any, is not checked."""
    import repro_torch
    from repro_torch.kernels import _build
    _build.build_all(["moe_gmm", "moe_gmm_bwd"])
    lines = [ln.strip() for ln in _build.build_log("moe_gmm_bwd")
             .splitlines() if "registers" in ln or "spill" in ln
             or "entry function" in ln or "warning" in ln or "Loss" in ln]
    for ln in lines:
        say(f"[build] moe_gmm_bwd: {ln}")
    if not other:
        wgmma_gmm_bwd_report(lines)
    err = phase_gmm_backward()
    timing = phase_timing_gmm_bwd(card, gmm_bwd_passes(card))
    say(json.dumps({"src": str(Path(repro_torch.__file__).parents[1]),
                    "max_abs_err": err, "moe_gmm_bwd_timing": timing}))
    return 0


def phase_timing_gmm(card: str) -> dict:
    """The grouped expert FFN at the shapes phase 5's llama4 path gives it:
    the decode step at its served occupancy (4 distinct live experts, one
    token each at slot 0), the decode step with every row filled, and the
    prefill of the longest served prompt.  The bound counts the bytes of the
    experts the buffer makes live."""
    from repro_torch.kernels.moe_gmm import grouped_ffn, grouped_ffn_reference
    gen = torch.Generator("cuda").manual_seed(4)
    served = gmm_served_shapes()
    prefill = max((lb for lb in served if "prefill" in lb),
                  key=lambda lb: served[lb][2])
    saved = grouped_ffn.launches
    out = {}
    for key, label, occupancy in (
            ("decode_live", "llama4 decode", "decode4"),
            ("decode", "llama4 decode", None),
            ("prefill", prefill, None)):
        b, e, c, d, f = served[label]
        buf, wi, wg, wo = gmm_inputs(b, e, c, d, f, torch.bfloat16, gen)
        mask = live_mask((b, e, c), occupancy, gen)
        if mask is not None:
            buf = buf * mask.to(buf.dtype)
        live_rows = (buf != 0).any(-1)                       # (B, E, C)
        live = live_rows.any(-1).any(0).nonzero()[:, 0]      # live experts
        n_live, n_rows = int(live.numel()), int(live_rows.sum())
        # yardstick: the same work as four PyTorch calls (cuBLAS bmm x 3 and
        # silu * mul) on the live experts' (B*C, D) rows and weights,
        # gathered once outside the timing
        xe = buf.transpose(0, 1)[live].reshape(n_live, b * c, d).contiguous()
        wgl, wil, wol = (w[live].contiguous() for w in (wg, wi, wo))

        def library():
            h = torch.nn.functional.silu(torch.bmm(xe, wgl)) * \
                torch.bmm(xe, wil)
            return torch.bmm(h, wol)

        tag = f"moe_gmm {label} ({occupancy or 'every row'})"
        # kernel and yardstick in turns, three rounds each; the medians
        # are kept, and the card's clocks are read before and after
        say(f"[timing] {tag}: clocks before ({CLOCKS}) {card_line(CLOCKS)}")
        kernel_r, library_r = [], []
        for _ in range(3):
            kernel_r.append(time_ms(lambda: grouped_ffn(buf, wi, wg, wo), 20))
            library_r.append(time_ms(library, 20))
        say(f"[timing] {tag}: clocks after {card_line(CLOCKS)}; kernel rounds "
            f"{', '.join(f'{t:.4f}' for t in kernel_r)} ms, yardstick rounds "
            f"{', '.join(f'{t:.4f}' for t in library_r)} ms")
        kernel_ms = sorted(kernel_r)[1]
        library_ms = sorted(library_r)[1]
        device_ms = graph_ms(lambda: grouped_ffn(buf, wi, wg, wo))
        plain_ms = time_ms(lambda: grouped_ffn_reference(buf, wi, wg, wo), 5)
        # the products over the live rows; the live experts' weights
        flops, nbytes = kernel_model.moe_gmm(
            b, e, c, d, f, "swiglu", torch.bfloat16, live_rows=n_rows,
            live_experts=n_live)
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        res = {"label": label, "occupancy": occupancy or "every row",
               "shape": [b, e, c, d, f], "live_experts": n_live,
               "live_rows": n_rows, "ms": kernel_ms, "graph_ms": device_ms,
               "plain_ms": plain_ms,
               "library_ms": None, "yardstick_ms": library_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "flops": flops, "bytes": nbytes}
        say(f"[timing] {tag} {(b, e, c, d, f)} bf16 swiglu, {n_live} of {e} "
            f"experts live ({n_rows} rows): kernel {kernel_ms:.4f} ms "
            f"(median; replayed from a CUDA graph {device_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, bmm x 3 + silu*mul over the "
            f"live experts (yardstick, 4 calls) {library_ms:.4f} ms; bound "
            f"{res['bound_ms']:.4f} ms by {res['bound_by']} "
            f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.4f} GB); "
            f"{nbytes / kernel_ms / 1e6:.1f} GB/s achieved, "
            f"{100 * res['bound_ms'] / kernel_ms:.1f}% of bound [{card}]")
        out[key] = res
        del buf, wi, wg, wo, xe, wgl, wil, wol
        torch.cuda.empty_cache()
    grouped_ffn.launches = saved     # comparisons do not count
    return out


# the bf16 backward's launches by pass (moe_gmm_bwd.cu): the wgmma body's
# kernels, and the names of the mma.sync body's in a checkout that has one
# (the parent commit's, timed through --moe-bwd-only --src)
GMM_BWD_PASSES = {"scan": ("scan_rows",), "hidden": ("HiddenPass",
                                                     "hidden_pass"),
                  "dx": ("DxPass", "dx_pass"),
                  "weights": ("WeightPass", "dw_pass")}


def pass_ms(fn, card: str) -> dict:
    """The device time of each of the grouped-FFN backward's passes in one
    profiled bf16 call of ``fn`` (``profile_region``, GMM_BWD_PASSES); None
    for a pass whose kernels the profiler did not see (not measured)."""
    out = profile_region(fn, "moe_gmm backward", card, top=6,
                         groups=GMM_BWD_PASSES).get("groups", {})
    return {k: (out[k] if out.get(k) else None) for k in GMM_BWD_PASSES}


def gmm_bwd_passes(card: str) -> dict:
    """The grouped-FFN backward's device time by pass (``pass_ms``) at
    llama4-scout's training shape, taken early in a run: late in a whole run
    the profiler missed a backward call's first kernels, which a run of
    this alone never did."""
    from repro_torch.kernels.moe_gmm.kernel import grouped_ffn_bwd_cuda
    gen = torch.Generator("cuda").manual_seed(14)
    b, e, c, d, f = GMM_BWD_TRAIN
    buf, wi, wg, wo = gmm_inputs(b, e, c, d, f, torch.bfloat16, gen)
    dy = torch.randn(buf.shape, generator=gen, device="cuda").to(buf.dtype)
    passes = pass_ms(lambda: grouped_ffn_bwd_cuda(buf, wi, wg, wo, dy,
                                                  "swiglu"), card)
    del buf, wi, wg, wo, dy
    torch.cuda.empty_cache()
    return passes


def ssd_bwd_parts(card: str) -> dict:
    """The SSD backward's device time by launch (SSD_BWD_PARTS) at each of
    SSD_BWD_TIMED's training shapes, taken early in a run as
    ``gmm_bwd_passes`` is."""
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_bwd_cuda
    res = {}
    for label, shape in SSD_BWD_TIMED.items():
        gen = torch.Generator("cuda").manual_seed(16)
        x = ssd_inputs(*shape, True, gen)
        dy, ds = ssd_cotangents(shape, "both", gen)
        out = profile_region(lambda: ssd_intra_chunk_bwd_cuda(*x, dy, ds),
                             f"ssd backward {label} {shape}", card, top=6,
                             groups=SSD_BWD_PARTS).get("groups", {})
        res[label] = {k: out.get(k) or None for k in SSD_BWD_PARTS}
        del x, dy, ds
        torch.cuda.empty_cache()
    return res


def phase_timing_gmm_bwd(card: str, passes: dict) -> dict:
    """The grouped FFN at llama4-scout's training shape (GMM_BWD_TRAIN,
    every row filled: 16 live experts of 320 rows), bf16 swiglu.  The
    backward: a call of its binding (the checks of ``GroupedFFN`` stay
    outside the timed call), in three rounds taken in turns with its
    yardstick, autograd's backward of the forward's yardstick (``bmm`` x 3
    and silu * mul over the live experts, never called by the port); the
    call replayed from a CUDA graph; ``passes``, its passes' device times
    from ``gmm_bwd_passes``; the plain backward.  The forward at the same
    shape beside its own yardstick the same way."""
    from repro_torch.kernels.moe_gmm import (grouped_ffn,
                                             grouped_ffn_backward_reference,
                                             grouped_ffn_reference)
    from repro_torch.kernels.moe_gmm.kernel import grouped_ffn_bwd_cuda
    gen = torch.Generator("cuda").manual_seed(14)
    saved = grouped_ffn.launches, grouped_ffn.backward_launches
    b, e, c, d, f = GMM_BWD_TRAIN
    buf, wi, wg, wo = gmm_inputs(b, e, c, d, f, torch.bfloat16, gen)
    dy = torch.randn(buf.shape, generator=gen, device="cuda").to(buf.dtype)
    rows = b * c                                       # per expert, all live
    # the yardstick's operands: the experts' (B*C, D) rows gathered once
    xe = buf.transpose(0, 1).reshape(e, rows, d).contiguous()
    dye = dy.transpose(0, 1).reshape(e, rows, d).contiguous()
    yard = [t.detach().clone().requires_grad_() for t in (xe, wi, wg, wo)]

    def forward_yard(xx, wii, wgg, woo):
        h = torch.nn.functional.silu(torch.bmm(xx, wgg)) * torch.bmm(xx, wii)
        return torch.bmm(h, woo)

    out_y = forward_yard(*yard)

    def kernel():
        return grouped_ffn_bwd_cuda(buf, wi, wg, wo, dy, "swiglu")

    def library():
        return torch.autograd.grad(out_y, yard, dye, retain_graph=True)

    def fwd_kernel():
        return grouped_ffn(buf, wi, wg, wo)

    def fwd_library():
        return forward_yard(xe, wi, wg, wo)

    out = {}
    for key, kerns, lib in (("backward", {"kernel": kernel}, library),
                            ("forward", {"kernel": fwd_kernel},
                             fwd_library)):
        tag = f"moe_gmm {key} {GMM_BWD_TRAIN} (every row live)"
        for _ in range(2):
            for kern in kerns.values():
                kern()
            lib()
        say(f"[timing] {tag}: clocks before ({CLOCKS}) {card_line(CLOCKS)}")
        rounds = {name: [] for name in (*kerns, "yardstick")}
        for _ in range(3):
            for name, kern in kerns.items():
                rounds[name].append(time_ms(kern, 5, warmup=1))
            rounds["yardstick"].append(time_ms(lib, 5, warmup=1))
        say(f"[timing] {tag}: clocks after {card_line(CLOCKS)}; rounds "
            + "; ".join(f"{n} " + ", ".join(f"{t:.4f}" for t in r) + " ms"
                        for n, r in rounds.items()))
        med = {n: sorted(r)[1] for n, r in rounds.items()}
        graph = {n: graph_ms(kern, 5) for n, kern in kerns.items()}
        flops, nbytes = (kernel_model.moe_gmm_bwd if key == "backward"
                         else kernel_model.moe_gmm)(*GMM_BWD_TRAIN)
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        res = {"shape": list(GMM_BWD_TRAIN), "live_experts": e,
               "live_rows": e * rows, "ms": med["kernel"],
               "graph_ms": graph["kernel"], "library_ms": None,
               "yardstick_ms": med["yardstick"],
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "flops": flops, "bytes": nbytes}
        if key == "backward":
            res["passes_ms"] = passes
            res["plain_ms"] = time_ms(lambda: grouped_ffn_backward_reference(
                buf, wi, wg, wo, dy), 2, warmup=1)
        else:
            res["plain_ms"] = time_ms(lambda: grouped_ffn_reference(
                buf, wi, wg, wo), 2, warmup=1)
        for name in kerns:
            say(f"[timing] {tag} bf16 swiglu: kernel "
                f"{med[name]:.4f} ms (median; replayed from a CUDA graph "
                f"{graph[name]:.4f} ms), plain {res['plain_ms']:.4f} ms, "
                f"yardstick ("
                + ("autograd's backward of " if key == "backward" else "")
                + f"bmm x 3 + silu*mul) {med['yardstick']:.4f} ms, kernel / "
                f"yardstick {med[name] / med['yardstick']:.3f}; bound "
                f"{res['bound_ms']:.4f} ms by {res['bound_by']} "
                f"({flops / 1e12:.4f} TFLOP, {nbytes / 1e9:.4f} GB; the "
                f"other bound {min(t_ops, t_bytes):.4f} ms); "
                f"{flops / med[name] / 1e9:.2f} TFLOP/s achieved, "
                f"{100 * res['bound_ms'] / med[name]:.1f}% of bound "
                f"[{card}]")
        if key == "backward":
            say(f"[timing] {tag}: passes, device ms "
                + ", ".join(
                    f"{k} " + ("not measured (the profiler did not see "
                               "it)" if v is None else f"{v:.4f}")
                    for k, v in res["passes_ms"].items()))
        out[key] = res
    del buf, wi, wg, wo, dy, xe, dye, yard, out_y
    torch.cuda.empty_cache()
    grouped_ffn.launches, grouped_ffn.backward_launches = saved
    res = dict(out["backward"])
    res["forward"] = out["forward"]
    return res


def ssd_time(shape, card: str, gen) -> dict:
    """The SSD intra-chunk kernel at ``shape``, x bf16 as served: three
    rounds in turns with the yardstick, medians kept; a CUDA graph's replay
    for the device's time alone; the plain version."""
    from repro_torch.kernels.ssd import (ssd_intra_chunk,
                                         ssd_intra_chunk_reference)
    b, nc, l, h, p, n = shape
    xc, dtc, cum, bc, cc = ssd_inputs(*shape, True, gen)
    # yardstick: the two products alone as cuBLAS f32 bmm (TF32 off), on M
    # and the state weights built once outside the timing
    idx = torch.arange(l, device="cuda")
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        ~(idx[:, None] >= idx[None, :])[None, None, :, :, None], -2.0 ** 30)
    m = (torch.einsum("bcin,bcjn->bcij", cc, bc)[..., None] * seg.exp()
         * dtc[:, :, None, :, :])
    m = m.permute(0, 1, 4, 2, 3).reshape(-1, l, l).contiguous()
    xs = xc.float().permute(0, 1, 3, 2, 4).reshape(-1, l, p).contiguous()
    w = (torch.exp(cum[:, :, -1:, :] - cum) * dtc)
    bw = (bc[:, :, :, None, :] * w[..., None]).permute(0, 1, 3, 4, 2) \
        .reshape(-1, n, l).contiguous()
    del seg

    def library():
        return torch.bmm(m, xs), torch.bmm(bw, xs)

    def kernel():
        return ssd_intra_chunk(xc, dtc, cum, bc, cc)

    say(f"[timing] ssd_intra_chunk {shape}: clocks before ({CLOCKS}) "
        f"{card_line(CLOCKS)}")
    kernel_r, library_r = [], []
    for _ in range(3):
        kernel_r.append(time_ms(kernel, 20))
        library_r.append(time_ms(library, 20))
    say(f"[timing] ssd_intra_chunk {shape}: clocks after {card_line(CLOCKS)}"
        f"; kernel rounds {', '.join(f'{t:.4f}' for t in kernel_r)} ms, "
        f"yardstick rounds {', '.join(f'{t:.4f}' for t in library_r)} ms")
    device_ms = graph_ms(kernel)
    plain_ms = time_ms(lambda: ssd_intra_chunk_reference(xc, dtc, cum, bc,
                                                         cc), 5)
    kernel_ms, yard_ms = sorted(kernel_r)[1], sorted(library_r)[1]
    flops, nbytes = kernel_model.ssd(*shape)
    # the least time for this work: its operations at the bf16 tensor-core
    # rate (the kernel's products run there at f32 accuracy) or its bytes;
    # beside it the same work on f32 FMAs
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_f32 = flops / PEAK_F32_FLOPS * 1e3
    res = {"shape": list(shape), "ms": kernel_ms, "graph_ms": device_ms,
           "plain_ms": plain_ms, "library_ms": None, "yardstick_ms": yard_ms,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "f32_fma_bound_ms": max(t_f32, t_bytes), "bytes_bound_ms": t_bytes,
           "flops": flops, "bytes": nbytes}
    say(f"[timing] ssd_intra_chunk {shape} (B, NC, L, H, P, N) x bf16: "
        f"kernel {kernel_ms:.4f} ms (median; replayed from a CUDA graph "
        f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, f32 bmm x 2 on "
        f"prepared M and state weights (yardstick only; no single PyTorch "
        f"call computes this) {yard_ms:.4f} ms; bound {res['bound_ms']:.4f} "
        f"ms by {res['bound_by']} ({flops / 1e9:.4f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB), on f32 FMAs "
        f"{res['f32_fma_bound_ms']:.4f} ms; {flops / kernel_ms / 1e9:.2f} "
        f"TFLOP/s achieved, {100 * res['bound_ms'] / kernel_ms:.1f}% of "
        f"bound, graph {100 * res['bound_ms'] / device_ms:.1f}% [{card}]")
    return res


def phase_timing_ssd(card: str) -> dict:
    """The SSD intra-chunk kernel at mamba2's longest served prefill (663
    tokens, padded to 3 chunks of 256) and at the one-chunk prompts of 254
    and 92 tokens."""
    from repro_torch.kernels.ssd import ssd_intra_chunk
    gen = torch.Generator("cuda").manual_seed(6)
    saved = ssd_intra_chunk.launches
    out = ssd_time(SSD_TIMED, card, gen)
    out["one_chunk"] = {str(s[2]): ssd_time(s, card, gen)
                        for s in SSD_ONE_CHUNK}
    ssd_intra_chunk.launches = saved     # comparisons do not count
    return out


def ssd_bwd_issued(b, nc, l, h, p, n) -> int:
    """The bf16 tensor-core work the SSD backward issues, x in bf16
    (ssd_intra_chunk_bwd.cu's table of products): each product at the
    function's size times its part-products (three with X, six for f32 x
    f32), dM twice (the per-head kernel and dCB's), C B^T once on FMAs.
    Printed beside the function's work, never in its bound."""
    pairs = l * (l + 1) // 2
    dm, state = 2 * pairs * p, 2 * l * n * p
    per_head = dm * (3 + 3) + dm * 6 + state * 6 + state * 3
    return b * nc * (h * per_head + 2 * pairs * n * (6 + 6 + 1))


# the SSD backward's launches by part (ssd_intra_chunk_bwd.cu); its C B^T
# launch is the forward's kernel taking the backward's BwdArgs
SSD_BWD_PARTS = {"per head": ("ssd_bwd_head",), "dCB": ("ssd_bwd_dcb",),
                 "state term": ("ssd_bwd_state",), "dB, dC": ("ssd_bwd_bc",),
                 "C B^T": ("ssd_cb_kernel",)}
# the shapes phase 6 times it at: mamba2-780m's and zamba2-2.7b's training
SSD_BWD_TIMED = {"mamba2": SSD_BWD_TRAIN, "zamba2": SSD_BWD_ZAMBA2}


def ssd_bwd_time(shape, card: str, parts: dict | None) -> dict:
    """The SSD backward at ``shape``, x bf16: a call of its binding (the
    checks of ``SSDIntraChunk`` stay outside the timed call), in three
    rounds taken in turns with its yardstick, autograd's backward of the f32
    ``bmm`` spelling of the plain forward (M and the state weights built
    from the inputs, then two ``bmm``; never called by the port); the call
    replayed from a CUDA graph; ``parts``, each launch's device time from
    ``ssd_bwd_parts``; the plain backward."""
    from repro_torch.kernels.ssd import ssd_intra_chunk_backward_reference
    from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_bwd_cuda
    gen = torch.Generator("cuda").manual_seed(16)
    b, nc, l, h, p, n = shape
    x = ssd_inputs(*shape, True, gen)
    dy, ds = ssd_cotangents(shape, "both", gen)
    leaves = [t.detach().float().requires_grad_() for t in x]
    xc, dtc, cum, bc, cc = leaves
    idx = torch.arange(l, device="cuda")
    seg = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill(
        ~(idx[:, None] >= idx[None, :])[None, None, :, :, None], -2.0 ** 30)
    m = (torch.einsum("bcin,bcjn->bcij", cc, bc)[..., None] * seg.exp()
         * dtc[:, :, None, :, :]).permute(0, 1, 4, 2, 3).reshape(-1, l, l)
    xs = xc.permute(0, 1, 3, 2, 4).reshape(-1, l, p)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dtc
    bw = (bc[:, :, :, None, :] * w[..., None]).permute(0, 1, 3, 4, 2) \
        .reshape(-1, n, l)
    outs = (torch.bmm(m, xs), torch.bmm(bw, xs))
    cots = (dy.permute(0, 1, 3, 2, 4).reshape(-1, l, p).contiguous(),
            ds.reshape(-1, n, p))
    del seg, m, xs, w, bw

    def library():
        return torch.autograd.grad(outs, leaves, cots, retain_graph=True)

    def kernel():
        return ssd_intra_chunk_bwd_cuda(*x, dy, ds)

    tag = f"ssd_intra_chunk_bwd {shape}"
    for _ in range(2):
        kernel()
        library()
    say(f"[timing] {tag}: clocks before ({CLOCKS}) {card_line(CLOCKS)}")
    rounds = {"kernel": [], "yardstick": []}
    for _ in range(3):
        rounds["kernel"].append(time_ms(kernel, 10, warmup=1))
        rounds["yardstick"].append(time_ms(library, 5, warmup=1))
    say(f"[timing] {tag}: clocks after {card_line(CLOCKS)}; rounds "
        + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in r) + " ms"
                    for k, r in rounds.items()))
    med = {k: sorted(r)[1] for k, r in rounds.items()}
    device_ms = graph_ms(kernel, 10)
    plain_ms = time_ms(lambda: ssd_intra_chunk_backward_reference(
        *x, dy, ds), 2, warmup=1)
    flops, nbytes = kernel_model.ssd_bwd(*shape)
    issued = ssd_bwd_issued(*shape)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_f32 = flops / PEAK_F32_FLOPS * 1e3
    res = {"shape": list(shape), "ms": med["kernel"], "graph_ms": device_ms,
           "plain_ms": plain_ms, "library_ms": None,
           "yardstick_ms": med["yardstick"],
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "f32_fma_bound_ms": max(t_f32, t_bytes), "bytes_bound_ms": t_bytes,
           "parts_ms": parts, "flops": flops, "bytes": nbytes,
           "issued_flops": issued,
           "issued_tflops": issued / device_ms / 1e9}
    say(f"[timing] {tag} (B, NC, L, H, P, N) x bf16: kernel "
        f"{res['ms']:.4f} ms (median; replayed from a CUDA graph "
        f"{device_ms:.4f} ms), plain {plain_ms:.4f} ms, yardstick "
        f"(autograd's backward of the f32 bmm spelling; no single PyTorch "
        f"call computes this) {res['yardstick_ms']:.4f} ms, kernel / "
        f"yardstick {res['ms'] / res['yardstick_ms']:.3f}; bound "
        f"{res['bound_ms']:.4f} ms by {res['bound_by']} "
        f"({flops / 1e9:.4f} GFLOP, {nbytes / 1e6:.2f} MB), on f32 FMAs "
        f"{res['f32_fma_bound_ms']:.4f} ms; {flops / res['ms'] / 1e9:.2f} "
        f"TFLOP/s achieved, {100 * res['bound_ms'] / res['ms']:.1f}% of "
        f"bound, graph {100 * res['bound_ms'] / device_ms:.1f}%; issued "
        f"(the split's part-products, dM twice) {issued / 1e9:.2f} GFLOP, "
        f"{res['issued_tflops']:.1f} TFLOP/s on the graph's time [{card}]")
    say(f"[timing] {tag}: launches, device ms "
        + ", ".join(f"{k} " + ("not measured" if v is None else f"{v:.4f}")
                    for k, v in (parts or {}).items()))
    del x, dy, ds, leaves, outs, cots
    torch.cuda.empty_cache()
    return res


def phase_timing_ssd_bwd(card: str, parts: dict) -> dict:
    """The SSD backward at mamba2-780m's training shape (its numbers at the
    top level) and at zamba2-2.7b's (under "zamba2"), each by
    ``ssd_bwd_time`` with its launches' device times from ``parts``."""
    res = ssd_bwd_time(SSD_BWD_TIMED["mamba2"], card, parts.get("mamba2"))
    res["zamba2"] = ssd_bwd_time(SSD_BWD_TIMED["zamba2"], card,
                                 parts.get("zamba2"))
    return res


def ssd_fwd_digest() -> dict:
    """sha256 of the SSD forward's y and states at fixed inputs, one case a
    body (bf16 x by cp.async, bf16 x by plain loads, f32 x): a change to code
    the forward compiles must leave these bit for bit."""
    import hashlib
    from repro_torch.kernels.ssd import ssd_intra_chunk
    saved = ssd_intra_chunk.launches
    gen = torch.Generator("cuda").manual_seed(7)
    out = {}
    for label, shape, bf, layout in (
            ("bf16", SSD_TIMED, True, "contiguous"),
            ("bf16 unaligned", (1, 2, 200, 6, 64, 128), True, "unaligned"),
            ("f32", (1, 2, 128, 4, 64, 64), False, "contiguous")):
        x = ssd_inputs(*shape, bf, gen, 0.01, layout)
        y, st = ssd_intra_chunk(*x)
        out[label] = hashlib.sha256(y.cpu().numpy().tobytes()
                                    + st.cpu().numpy().tobytes()).hexdigest()
    ssd_intra_chunk.launches = saved
    say("[kernels] ssd_intra_chunk forward's outputs, sha256: "
        + "; ".join(f"{k} {v[:16]}" for k, v in out.items()))
    return out


def ssd_only(card: str) -> int:
    """``--ssd-only``: the SSD kernels of the tree whose ``src`` is on the
    path, the forward and (where the tree has it) the backward, held against
    their plain versions (phase 3's SSD cases) and timed (phase 6's SSD
    shapes); one JSON line.  With ``--src`` this times another checkout's
    kernels, e.g. the parent commit's, in the same call."""
    import repro_torch
    from repro_torch.kernels import _build
    names = [k for k in ("ssd_intra_chunk", "ssd_intra_chunk_bwd")
             if k in _build.SOURCES]       # another checkout may lack one
    _build.build_all(names)
    for name in names:
        lines = [ln.strip() for ln in _build.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln
                 or "entry function" in ln]
        say(f"[build] {name} by instantiation: "
            + "; ".join(f"{k}: {v}" for k, v in
                        instantiations(lines).items()))
    out = {"src": str(Path(repro_torch.__file__).parents[1]),
           "fwd_sha256": ssd_fwd_digest(),
           "max_abs_err": phase_ssd(), "ssd_timing": phase_timing_ssd(card)}
    if "ssd_intra_chunk_bwd" in names:
        out["bwd_max_abs_err"] = phase_ssd_backward()
        out["ssd_bwd_timing"] = phase_timing_ssd_bwd(card,
                                                     ssd_bwd_parts(card))
    say(json.dumps(out))
    return 0



# ------------------------------------------------------------- phase 7
def dry_run(arch: str, kind: str, n_layers: int, batch: int, seq: int,
            moments: str | None = None) -> dict:
    """One cell of ``launch/dryrun.py`` on meta at a main path's exact
    config and sizes; it must end "ok"."""
    from repro_torch.launch import dryrun
    shape = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    row = dryrun.run_cell(arch, shape, verbose=False,
                          cfg_overrides={"n_layers": n_layers}, batch=batch,
                          seq=seq, moments=moments)
    assert row["status"] == "ok", (arch, kind, row.get("traceback"))
    return row


def roofline_part(rows: list, measured_ms: float) -> dict:
    """A step kind's dry-run rows (one a call) beside its measured time:
    counted FLOPs and bytes by kind, the bound, MODEL_FLOPS, the dry run's
    peak, and mfu = model_flops / (measured s x peak), bound_share = bound /
    measured."""
    kinds: dict = {}
    for r in rows:
        for k, v in r["counts"]["kinds"].items():
            acc = kinds.setdefault(k, {"flops": 0, "bytes": 0})
            acc["flops"] += v["flops"]
            acc["bytes"] += v["bytes"]
    bound_ms = 1e3 * sum(r["bound_s"] for r in rows)
    mf = sum(r["model_flops"] for r in rows)
    return {"calls": len(rows), "kinds": kinds,
            "flops": sum(r["counts"]["flops"] for r in rows),
            "bytes": sum(r["counts"]["bytes"] for r in rows),
            "bound_ms": bound_ms,
            "bottleneck": sorted({r["roofline"]["bottleneck"]
                                  for r in rows}),
            "model_flops": mf,
            "dryrun_peak_gb": max(r["memory"]["peak_bytes"]
                                  for r in rows) / 1e9,
            "measured_ms": measured_ms,
            "mfu": mf / (measured_ms / 1e3 * PEAK_BF16_FLOPS),
            "bound_share": bound_ms / measured_ms}


def roofline_row(p: dict) -> dict:
    """Phase 7a for one main path: each of its step kinds dry-run on meta
    at the path's config, batch, layers and moments, beside what phase 5
    measured; the dry run's peak over the measured ``max_memory_allocated``
    (peak_ratio; the dry run sees neither the allocator's rounding nor
    cuBLAS's workspaces, so it is recorded, not held)."""
    from repro_torch.configs import get_config
    arch, layers = p["arch"], p["n_layers"]
    cfg = get_config(arch)
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    parts = {}
    if p.get("path") == "train":
        rows = [dry_run(arch, "train", layers, p["batch"],
                        p["seq_len"] + extra, p["moment_dtype"])]
        parts["train"] = roofline_part(rows, p["ms_per_step"])
        parts["train"]["rows"] = rows
    else:
        lens = p["prompt_lens"]
        if cfg.family in ("encdec", "vlm"):      # one batch of the prompts
            pre = [dry_run(arch, "prefill", layers, len(lens),
                           lens[0] + extra)]
            dec_batch, dec_len = len(lens), lens[0] + SERVE_NEW + extra
        else:                                    # the engine: one a request
            pre = [dry_run(arch, "prefill", layers, 1, n) for n in lens]
            dec_batch, dec_len = SERVE_SLOTS, SERVE_MAX_LEN
        parts["prefill"] = roofline_part(pre, sum(p["prefill_ms"]))
        parts["decode"] = roofline_part(
            [dry_run(arch, "decode", layers, dec_batch, dec_len)],
            p["decode_ms_per_step"])
    peak = max(part["dryrun_peak_gb"] for part in parts.values())
    return {"arch": arch, "n_layers": layers,
            "path": p.get("path", "serve"), "parts": parts,
            "dryrun_peak_gb": peak,
            "measured_peak_gb": p["max_memory_allocated_gb"],
            "peak_ratio": peak / p["max_memory_allocated_gb"]}


def winner_reference(key: np.ndarray, ids: np.ndarray) -> int:
    """The scheduler's staged reduction in numpy: the least key, then the
    least id among its ties (repro/core/copmatrix.py, written out here)."""
    big = np.iinfo(np.int64).max
    return int(np.where(key == key.min(), ids, big).min())


def winner_draws(n_draws: int = 1200):
    """(key, ids) draws at n in WINNER_SIZES: float64 keys with ties and
    +inf (some all +inf), int64 keys near int64 max, ids from a permutation
    or near int64 max."""
    rng = np.random.default_rng(8)
    big = np.iinfo(np.int64).max
    for i in range(n_draws):
        n = WINNER_SIZES[i % len(WINNER_SIZES)]
        if i % 2:
            key = big - rng.integers(0, 4, n)
        else:
            key = rng.integers(0, 6, n).astype(np.float64)
            key[rng.random(n) < (1.0 if i % 10 == 0 else 0.2)] = np.inf
        ids = rng.permutation(n).astype(np.int64)
        if i % 4 == 3:
            ids = big - 1 - ids
        yield key, ids


WINNER_SIZES = (1, 3, 7, 16, 33, 1000, 4096, 4097)


def phase_winner(card: str) -> dict:
    """Phase 7c: the scheduler's winner twin (``repro_torch.core.
    torch_winner``) on the card against the numpy staged reduction, every
    draw bit-identical; one call at n = 4096 timed beside numpy's (host
    clock; the twin's inputs lie on the card, its answer is read back)."""
    from repro_torch.core import torch_winner
    winner = torch_winner("cuda")

    def on_card(key, ids):
        return torch.from_numpy(key).cuda(), torch.from_numpy(ids).cuda()

    n = 0
    for key, ids in winner_draws():
        got, want = winner(*on_card(key, ids)), winner_reference(key, ids)
        assert got == want, f"winner twin {got} != numpy {want} at n " \
            f"{len(key)} ({key.dtype})"
        n += 1
    key, ids = next(k for k in winner_draws() if len(k[0]) == 4096)

    def per_call_ms(fn, *args, calls=200):
        fn(*args)
        t = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        return 1e3 * (time.perf_counter() - t) / calls

    res = {"draws": n, "sizes": list(WINNER_SIZES),
           "twin_ms_4096": per_call_ms(winner, *on_card(key, ids)),
           "numpy_ms_4096": per_call_ms(winner_reference, key, ids)}
    say(f"[roofline] winner twin: {n} draws at n in {WINNER_SIZES} "
        f"(float64 keys with ties and inf, int64 keys near int64 max) "
        f"bit-identical to numpy's staged reduction; one call at n 4096: "
        f"twin {res['twin_ms_4096']:.4f} ms, numpy "
        f"{res['numpy_ms_4096']:.4f} ms (host clock, the twin's inputs on "
        f"the card) "
        f"[{card}]")
    return res


def phase_roofline(paths: list, card: str) -> dict:
    """Phase 7: (a) a roofline row for each main path from the meta dry run
    at its exact sizes, beside its measured times and peak; (b) the
    training steps counted on the card (deepseek-7b, llama4-scout at 2
    layers, mamba2-780m) equal to the same steps counted on meta, kind by
    kind, exactly, with one kernel call for each launch of a step; (c) the
    winner twin."""
    rows = []
    for p in paths:
        row = roofline_row(p)
        rows.append(row)
        for kind, part in row["parts"].items():
            by_kind = ", ".join(
                f"{k} {v['flops'] / 1e12:.3f} TFLOP {v['bytes'] / 1e9:.2f} GB"
                for k, v in sorted(part["kinds"].items()))
            say(f"[roofline] {row['arch']} x{row['n_layers']} {row['path']} "
                f"{kind} ({part['calls']} dry-run call"
                f"{'s' if part['calls'] > 1 else ''}): counted "
                f"{part['flops'] / 1e12:.3f} TFLOP, "
                f"{part['bytes'] / 1e9:.2f} GB ({by_kind}); bound "
                f"{part['bound_ms']:.3f} ms by {'/'.join(part['bottleneck'])}"
                f"; model_flops {part['model_flops'] / 1e12:.3f} TFLOP; "
                f"measured {part['measured_ms']:.3f} ms; mfu "
                f"{100 * part['mfu']:.2f} %, bound_share "
                f"{100 * part['bound_share']:.2f} % [{card}]")
        say(f"[roofline] {row['arch']} x{row['n_layers']} {row['path']}: "
            f"dry-run peak {row['dryrun_peak_gb']:.2f} GB, measured "
            f"{row['measured_peak_gb']:.2f} GB, peak_ratio "
            f"{row['peak_ratio']:.3f}")
    checked = []
    for p, row in zip(paths, rows):
        if "card_count" not in p:
            continue
        card_c = p["card_count"]
        meta_c = row["parts"]["train"]["rows"][0]["counts"]
        per_step = {k: v // TRAIN_STEPS for k, v in p["launches"].items()
                    if v}
        assert card_c["kinds"] == meta_c["kinds"], \
            f"{p['arch']}: card count {card_c['kinds']} != meta " \
            f"{meta_c['kinds']}"
        assert card_c["calls"] == meta_c["calls"] == per_step, \
            f"{p['arch']}: calls card {card_c['calls']}, meta " \
            f"{meta_c['calls']}, launches a step {per_step}"
        say(f"[roofline] {p['arch']} x{p['n_layers']} train: the card's "
            f"count equals the meta count kind by kind "
            f"({card_c['flops']} FLOPs, {card_c['bytes']} bytes; calls "
            f"{card_c['calls']} = launches a step) [{card}]")
        checked.append(p["arch"])
    assert sorted(checked) == sorted(CARD_COUNT), checked
    for row in rows:
        for part in row["parts"].values():
            part.pop("rows", None)
    return {"paths": rows, "card_equals_meta": checked,
            "winner": phase_winner(card)}


# ------------------------------------------------------------- phase 8
# expert parallelism (launch/mesh.py, launch/shardings.py, models/mlp.py's
# _moe_expert_parallel and _moe_expert_parallel_a2a) at llama4-scout's full
# widths cut to MOE_TRAIN_LAYERS layers, as 5c: the MoE layer's forward and
# backward, then EP_STEPS make_train_step steps from the seed-0 state, in
# each sharding mode ("tp": the all-reduce path, with tensor parallelism;
# "fsdp": the all-to-all path, every leaf in the ZeRO-3 layout and gathered
# a layer at a time), on NCCL over every card up to EP_MAX_WORLD
EP_STEPS = 3
EP_MAX_WORLD = 4
EP_MODES = ("tp", "fsdp")
# bounds on each rank of a world of 2 or more against the dense dispatch on
# one card (bf16): the grouped FFN's kernels run other expert counts, so
# other split grids and sums in other orders; about the rounding of one
# bf16 op (2^-8), a third of the bf16-vs-f32 bounds of phase 4 (not yet
# measured: the card machine has one card).  The all-to-all mode's
# capacity is a slice's, so it is held there at a capacity factor of E / k,
# at which no slice drops a token, against the dense dispatch at the same
EP_Y_REL, EP_GRAD_REL, EP_LOSS_REL = 1e-2, 1e-2, 1e-3


def ep_config():
    from repro_torch.configs import get_config
    return get_config(LLAMA4).replace(n_layers=MOE_TRAIN_LAYERS)


def ep_inputs(cfg, device: str):
    """The MoE layer's input (TRAIN_BATCH, TRAIN_SEQ, d_model) bf16 and a
    training batch of TRAIN_BATCH x TRAIN_SEQ tokens, from seed 20."""
    gen = torch.Generator(device).manual_seed(20)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         generator=gen, device=device)
    return x, {"tokens": toks[:, :-1].contiguous(),
               "labels": toks[:, 1:].contiguous()}


class EPCalls:
    """Counts the calls of the two expert-parallel paths of
    ``models/mlp.py`` (wrapped for the phase, restored after), to show that
    a variant ran the path it names."""

    def __enter__(self):
        from repro_torch.models import mlp
        self.mlp, self.calls = mlp, {"tp": 0, "fsdp": 0}
        self.orig = {"tp": mlp._moe_expert_parallel,
                     "fsdp": mlp._moe_expert_parallel_a2a}

        def counted(mode):
            def run(*args):
                self.calls[mode] += 1
                return self.orig[mode](*args)
            return run

        mlp._moe_expert_parallel = counted("tp")
        mlp._moe_expert_parallel_a2a = counted("fsdp")
        return self

    def __exit__(self, *exc):
        self.mlp._moe_expert_parallel = self.orig["tp"]
        self.mlp._moe_expert_parallel_a2a = self.orig["fsdp"]


def ep_compare(got: dict, ref: dict) -> dict:
    """{name: max |got - ref|} over the tensors of ``ref`` (host copies),
    and whether every one is bit-identical."""
    diff = {}
    for k, want in ref.items():
        have = got[k]
        assert have.shape == want.shape and have.dtype == want.dtype, k
        diff[k] = 0.0 if torch.equal(have, want) else float(
            (have.float() - want.float()).abs().max())
    return diff


def ep_variant(cfg, mesh, mode: str, device: str, ref=None,
               card: str | None = None) -> dict:
    """One variant on ``mesh`` (None: the dense dispatch of one process),
    every launch counted from 0: the MoE layer's forward and backward on
    x (y, aux, gradients of sum(y^2) in x and the layer's weights), then
    EP_STEPS ``make_train_step`` steps from the seed-0 state (AdamW with
    bf16 moments) with the step-1 gradients as AdamW takes them.  Without
    ``ref`` the results come back as host tensors; with it each is
    compared with ``ref``'s as it comes and only the differences are kept.
    Then, given the ``card``'s name, one profiled step."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode, use_mesh
    from repro_torch.models.mlp import moe_forward
    from repro_torch.optim import AdamW, AdamWConfig
    set_sharding_mode(mode)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        model = Model(cfg, device=device, mesh=mesh).init(
            torch.Generator(device).manual_seed(0))
        x, batch = ep_inputs(cfg, device)
        out: dict = {}
        keep = (lambda k, t: out.__setitem__(k, t.detach().cpu())) \
            if ref is None else (lambda k, t: out.__setitem__(
                k, ep_compare({k: t.detach().cpu()}, {k: ref[k]})[k]))
        zero_counts()
        with EPCalls() as calls:
            lp = {k: v[0].detach().requires_grad_()
                  for k, v in model.params["layers"]["moe"].items()}
            xx = x.clone().requires_grad_()
            with use_mesh(mesh):
                y, aux = moe_forward(lp, xx, cfg)
                grads = torch.autograd.grad(y.float().square().sum(),
                                            [xx, *lp.values()])
            keep("layer/y", y)
            keep("layer/aux", aux)
            for k, g in zip(["x", *lp], grads):
                keep(f"layer/grad/{k}", g)
            del y, grads, lp, xx
            opt = AdamW(AdamWConfig(warmup_steps=1, total_steps=EP_STEPS,
                                    moment_dtype="bfloat16"))
            update, step1 = opt.update, []

            def capture(g, *args, **kw):
                if not step1:
                    step1.append(True)
                    for n, t in g.items():
                        keep(f"step1/{n}", t)
                return update(g, *args, **kw)

            opt.update = capture
            params = dict(model.named_parameters())
            state = {"params": params, "opt": opt.init(params)}
            step_fn = make_train_step(model, opt)
            losses, step_s = [], []
            for _ in range(EP_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, met = step_fn(state, batch)
                losses.append(float(met["loss"]))
                step_s.append(time.perf_counter() - t)
            opt.update = update
        launches = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        keep("losses", torch.tensor(losses, dtype=torch.float64))
        res = {"mode": mode, "mesh": None if mesh is None else
               list(mesh.mesh.shape), "launches": launches,
               "ep_calls": dict(calls.calls), "losses": losses,
               "step_ms": [1e3 * t for t in step_s],
               "ms_per_step": 1e3 * float(np.median(step_s[1:])),
               "max_memory_allocated_gb": peak_gb, "out": out}
        if card is not None:
            where = "the dense dispatch" if mesh is None else \
                f"{mode} on {tuple(mesh.mesh.shape)}"
            res["profile"] = profile_region(
                lambda: step_fn(state, batch), f"{cfg.name} x{cfg.n_layers}:"
                f" one training step, {where}", card, groups=EP_GROUPS)
        return res
    finally:
        set_sharding_mode("tp")


# a step's device time by kind: NCCL's kernels first, then TRAIN_GROUPS'
EP_GROUPS = {"nccl": ("nccl",), **TRAIN_GROUPS}


def ep_rank(rank: int, world: int, store: str, out_dir: str, mode: str,
            cf: float) -> None:
    """One process of the multi-card part: rank ``rank`` on card ``rank``
    of a (1, world) mesh over NCCL, at capacity factor ``cf``; its results
    to out_dir/rank<r>.pt."""
    from repro_torch.launch.mesh import make_mesh
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((1, world), ("data", "model"), device="cuda")
        res = ep_variant(ep_config().replace(capacity_factor=cf), mesh, mode,
                         "cuda")
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def ep_multi(world: int, mode: str, cf: float, dense: dict,
             want: dict) -> dict:
    """The multi-card part: one process a card, each rank's output (the
    whole y: the mesh splits no tokens), its replicated leaves' gradients,
    its slice of the experts' gradients and the losses held to the dense
    dispatch on one card at the same capacity factor within the bf16
    bounds."""
    import torch.multiprocessing as mp
    cfg = ep_config()
    nm = world
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(ep_rank, args=(world, os.path.join(d, "store"), d,
                                          mode, cf), nprocs=world, join=True,
                           start_method="spawn")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"))
                 for r in range(world)]
    calls = 1 + 2 * cfg.n_layers * EP_STEPS
    for res in ranks:
        assert res["launches"] == want, (res["launches"], want)
        assert res["ep_calls"][mode] == calls, res["ep_calls"]
    worst = {"y": 0.0, "grad": 0.0, "loss": 0.0}
    e_loc = cfg.n_experts // nm
    for r, res in enumerate(ranks):
        for k, want in dense["out"].items():
            have = res["out"][k]
            if have.shape != want.shape:          # an expert leaf's slice
                lead = want.dim() - 3
                want = want.narrow(lead, r * e_loc, e_loc)
            err = leaf_rel(have.float(), want.float())
            kind = ("y" if k == "layer/y" else "loss" if k == "losses"
                    else "grad")
            worst[kind] = max(worst[kind], err)
    assert worst["y"] <= EP_Y_REL and worst["grad"] <= EP_GRAD_REL and \
        worst["loss"] <= EP_LOSS_REL, worst
    return {"world": world, "mode": mode, "capacity_factor": cf,
            "worst_rel": worst,
            "ms_per_step": [res["ms_per_step"] for res in ranks],
            "launches": [res["launches"] for res in ranks]}


def phase_expert_parallel(card: str, dense_ms: float | None) -> dict:
    """Phase 8: the dense dispatch, then each sharding mode on a (1, 1)
    NCCL mesh, all on this card: every output, aux, step-1 gradient and
    loss bit-identical to the dense dispatch's, the grouped FFN's kernels
    launched on the expert-parallel path (one forward a MoE layer a pass:
    the layer's call, each step's forward and remat's recompute; one
    backward a layer a step and the layer's), the path's calls counted.
    With 2 or more cards, each mode again on a (1, world) mesh, one process
    a card, held to the dense dispatch within bf16 bounds."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    cfg = ep_config()
    n = cfg.n_layers
    world = min(EP_MAX_WORLD, torch.cuda.device_count())
    dense = ep_variant(cfg, None, "tp", "cuda", card=card)
    want = {"flash_attn_fwd": 2 * n * EP_STEPS, "flash_attn_bwd": n *
            EP_STEPS, "moe_gmm": 1 + 2 * n * EP_STEPS,
            "moe_gmm_bwd": 1 + n * EP_STEPS, "ssd_intra_chunk": 0,
            "ssd_intra_chunk_bwd": 0}
    assert dense["launches"] == want, (dense["launches"], want)
    assert dense["ep_calls"] == {"tp": 0, "fsdp": 0}, dense["ep_calls"]
    ref = dense["out"]
    results = {"dense": {k: v for k, v in dense.items() if k != "out"}}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
            for mode in EP_MODES:
                res = ep_variant(cfg, mesh, mode, "cuda", ref=ref, card=card)
                diffs = res.pop("out")
                bad = {k: v for k, v in diffs.items() if v != 0.0}
                assert not bad, f"[ep {mode}] not bit-identical: {bad}"
                assert res["launches"] == want, (res["launches"], want)
                calls = {m: (1 + 2 * n * EP_STEPS if m == mode else 0)
                         for m in EP_MODES}
                assert res["ep_calls"] == calls, (res["ep_calls"], calls)
                res["bit_identical"] = sorted(diffs)
                results[mode] = res
        finally:
            dist.destroy_process_group()
    tag = f"[ep {cfg.name}]"
    say(f"{tag} {n} layers at full widths ({widths(cfg)}), bf16, remat "
        f"{cfg.remat}: the MoE layer's forward and backward on "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, then {EP_STEPS} make_train_step"
        f" steps (AdamW, bf16 moments) from one state")
    say(f"{tag} world 1 on NCCL (one card"
        + ("" if world > 1 else "; the machine has one card, so the "
           "(1, world) part runs at world 1 only")
        + f"): both modes bit-identical to the dense dispatch in y, aux, the"
        f" layer's gradients, all {sum(k.startswith('step1/') for k in ref)}"
        f" step-1 gradient leaves and"
        f" the {EP_STEPS} losses " + ", ".join(
            f"{x:.6f}" for x in dense["losses"]) + f" [{card}]")
    for key, res in results.items():
        prof = res.get("profile", {})
        groups = prof.get("groups", {})
        nccl = groups.get("nccl", 0.0)
        say(f"{tag} {key}: {res['ms_per_step']:.2f} ms/step (median of "
            f"steps 2-{EP_STEPS}; steps " + ", ".join(
                f"{t:.1f}" for t in res["step_ms"]) + " ms"
            + (f"; phase 5c's Trainer step {dense_ms:.2f} ms" if dense_ms
               else "") + f"), max memory {res['max_memory_allocated_gb']:.2f}"
            f" GB, launches {res['launches']}, path calls {res['ep_calls']}; "
            f"profiled step: NCCL kernels {nccl:.3f} ms ({nccl / n:.3f} ms a "
            f"layer), device busy {prof.get('device_busy_ms', 0.0):.2f} ms "
            f"[{card}]")
    if world > 1:
        no_drop = cfg.n_experts / cfg.top_k
        dense_nd = ep_variant(cfg.replace(capacity_factor=no_drop), None,
                              "tp", "cuda")
        results["multi"] = [
            ep_multi(world, "tp", cfg.capacity_factor, dense, want),
            ep_multi(world, "fsdp", no_drop, dense_nd, want)]
        for m in results["multi"]:
            say(f"{tag} world {m['world']} {m['mode']}, capacity factor "
                f"{m['capacity_factor']:g}: worst rel against "
                f"the dense dispatch {m['worst_rel']} (bounds y {EP_Y_REL}, "
                f"gradients {EP_GRAD_REL}, losses {EP_LOSS_REL}); ms/step "
                f"by rank {m['ms_per_step']} [{card}]")
    paths = [{"arch": cfg.name, "n_layers": n, "path": f"ep-{mode} world 1",
              "launches": results[mode]["launches"]} for mode in EP_MODES]
    return {"card": card, "world": world, "results": results,
            "paths": paths}


# ------------------------------------------------------------- phase 9
# tensor parallelism ("tp": every leaf the rules split over "model" held as
# the rank's slice and computed on as such; launch/shardings.py,
# models/attention.py, mlp.py, lm.py; the checkpoint of whole leaves,
# runtime/checkpoint.py) at deepseek-7b's published widths: (a) world 1 on
# NCCL, a (1, 1) mesh, against the same work without a mesh: TP_STEPS
# make_train_step steps at WIDE_LAYERS layers, phase 5's requests served at
# full depth, a checkpoint saved and restored; (b) each rank's part of one
# full-width layer at each "model" size of TP_RANKS, in one process,
# against the whole layer
TP_STEPS = 3
# steps timed after the held ones (the first variant's second step still
# builds cuBLAS's plans)
TP_TIMED_STEPS = 5
TP_RANKS = (2, 4)
# (a): at one rank of "model" the tensor-parallel path runs the arithmetic
# of one process (its collectives over one rank copy, the vocabulary-
# parallel loss is cross_entropy_loss's op for op), so every step-1
# gradient, loss and grad norm is held bit for bit.  (b): bounds on
# ||sum of the ranks' parts - whole|| / ||whole|| in bf16, where each
# rank's share of y and dx is rounded to bf16 before the sum: about twice
# what sound runs on the H100 gave (y 2.35e-3, dx 4.01e-3; the weight
# gradients, each rank's columns or rows of the whole layer's, came out
# bit-identical; PERF.md, findings)
TP_PART_REL = {"y": 5e-3, "dx": 8e-3, "grad": 1e-3}


def tp_config():
    from repro_torch.configs import get_config
    return get_config(TRAIN_ARCH).replace(n_layers=WIDE_LAYERS)


def layout_name(mesh, mode: str = "tp", zero1: bool = False) -> str:
    if mesh is None:
        return "without a mesh"
    return f"{mode}{' + ZeRO-1' if zero1 else ''} on {tuple(mesh.mesh.shape)}"


def tp_steps(cfg, mesh, state: dict, batch: dict, ref: dict | None = None,
             card: str | None = None, mode: str = "tp",
             zero1: bool = False, timed: int = TP_TIMED_STEPS) -> dict:
    """TP_STEPS ``make_train_step`` steps (AdamW, bf16 moments; ZeRO-1's
    with ``zero1``) of ``cfg`` from ``state`` on ``mesh`` (None: one
    process, no mesh) in sharding ``mode``, every launch counted from 0:
    losses, grad norms, the step-1 gradients as AdamW takes them (kept on
    the card; with ``ref``, each compared with ref's as it comes and only
    the differences kept) and the peak memory; then ``timed`` timed
    steps.  Given the ``card``'s name, one profiled step more.  Returns
    the model and its state too."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    from repro_torch.optim import AdamW, AdamWConfig
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # a copy: load_state keeps the tensors it is given, which the steps
    # update in place
    set_sharding_mode(mode)
    try:
        model = Model(cfg, device="cuda", mesh=mesh).load_state(
            {k: v.clone() for k, v in state.items()})
    finally:
        set_sharding_mode("tp")
    opt = AdamW(AdamWConfig(warmup_steps=1, total_steps=TP_STEPS,
                            moment_dtype="bfloat16"))
    update, step1 = opt.update, {}

    def capture(g, *args, **kw):
        if not step1:
            for n, t in g.items():
                step1[n] = t.detach().clone() if ref is None else (
                    0.0 if torch.equal(t, ref["grads"][n])
                    else leaf_rel(t, ref["grads"][n]))
        return update(g, *args, **kw)

    opt.update = capture
    params = dict(model.named_parameters())
    st = {"params": params, "opt": opt.init(params, model, zero1=zero1)}
    step_fn = make_train_step(model, opt)
    zero_counts()
    losses, norms, step_s = [], [], []
    for _ in range(TP_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, met = step_fn(st, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        step_s.append(time.perf_counter() - t)
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    opt.update = update
    for _ in range(timed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, met = step_fn(st, batch)
        float(met["loss"])
        step_s.append(time.perf_counter() - t)
    res = {"losses": losses, "grad_norms": norms, "grads": step1,
           "step_ms": [1e3 * t for t in step_s],
           "ms_per_step": 1e3 * float(np.median(step_s[TP_STEPS:])),
           "max_memory_allocated_gb": peak_gb, "launches": launches,
           "model": model, "state": st}
    if card is not None:
        where = layout_name(mesh, mode, zero1)
        res["profile"] = profile_region(
            lambda: step_fn(st, batch), f"{cfg.name} x{cfg.n_layers}: one "
            f"training step, {where}", card, groups=EP_GROUPS)
    return res


def tp_checkpoint(res: dict, mesh) -> dict:
    """(a)'s trained state saved on the mesh (whole leaves, rank 0 writes)
    and restored into a fresh model's zeroed leaves and zeroed moments:
    every leaf bit for bit."""
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    from repro_torch.runtime import CheckpointManager
    from repro_torch.runtime.checkpoint import flatten_state
    model, st = res["model"], res["state"]
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = CheckpointManager(d).save(TP_STEPS, st, model=model)
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        set_sharding_mode(model.mode)
        try:
            fresh = Model(model.cfg, device="cuda", mesh=mesh)
        finally:
            set_sharding_mode("tp")

        def zeros(like):
            return {n: torch.zeros_like(t) for n, t in like.items()}

        params = {n: torch.zeros(p.shape, dtype=p.dtype, device="cuda")
                  for n, p in fresh.named_parameters()}
        back = {"params": params, "opt": {
            "m": zeros(st["opt"]["m"]), "v": zeros(st["opt"]["v"]),
            "count": torch.zeros_like(st["opt"]["count"])}}
        t0 = time.perf_counter()
        CheckpointManager(d).restore(back, model=fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    want, got = flatten_state(st), flatten_state(back)
    assert set(want) == set(got)
    bad = [n for n in want if not torch.equal(got[n], want[n].detach())]
    assert not bad, f"[tp] checkpoint not restored exactly: {bad[:5]}"
    return {"leaves": len(want), "bytes": size, "save_s": save_s,
            "restore_s": restore_s}


def tp_serve(cfg, mesh, card: str, mode: str = "tp") -> dict:
    """Phase 5's requests of ``cfg`` (full depth) through ServingEngine on
    ``mesh`` (None: one process) in sharding ``mode``, launches counted
    from 0: the greedy tokens in request order, the flash launches, the
    drain's wall time, prefill ms a request and decode ms a step (host
    clock, synchronised), and one decode step profiled."""
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    from repro_torch.runtime import ServingEngine
    gc.collect()
    torch.cuda.empty_cache()
    set_sharding_mode(mode)
    try:
        model = Model(cfg, device="cuda", mesh=mesh).init(
            torch.Generator("cuda").manual_seed(0))
    finally:
        set_sharding_mode("tp")
    prefill_s, decode_s = time_calls(model)
    engine = ServingEngine(model, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    ids = [engine.submit(p, max_new=SERVE_NEW)
           for p in serve_prompts(cfg.vocab)]
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = {c.id: c.tokens for c in engine.run_until_drained()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"tokens": [done[i] for i in ids], "launches": read_counts(),
           "drain_s": wall,
           "prefill_ms_per_request": 1e3 * float(np.mean(prefill_s)),
           "decode_ms_per_step": 1e3 * float(np.mean(decode_s))}
    del model.prefill, model.decode_step
    tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int64, device="cuda")
    where = layout_name(mesh, mode)
    res["decode_profile"] = profile_region(
        lambda: model.decode_step(tok, engine.cache), f"{cfg.name}: one "
        f"decode step of {SERVE_SLOTS} slots, {where}", card, top=6,
        groups=EP_GROUPS)
    res["decode_host"] = host_profile(
        lambda: model.decode_step(tok, engine.cache),
        f"{cfg.name}: one decode step of {SERVE_SLOTS} slots, {where}")
    return res


def host_profile(fn, label: str, top: int = 10) -> list:
    """Where the host's time of one call of ``fn`` goes (cProfile, after a
    warm call, synchronised): the ``top`` functions by their own time."""
    import cProfile
    import pstats
    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:top]
    out = [(f"{Path(f).name}:{line}:{name}", calls, 1e3 * tt)
           for (f, line, name), (_, calls, tt, _, _) in rows]
    say(f"[host] {label}: {1e3 * stats.total_tt:.2f} ms under cProfile; "
        f"by own time:")
    for name, calls, ms in out:
        say(f"[host]   {ms:8.3f} ms  {calls:6d} calls  {name}")
    return out


def tp_layer(cfg, layer: dict, x, dy, part: str):
    """One full-width layer's attention or MLP (``part``) forward and
    backward on ``layer`` (its leaves, unstacked) without a mesh, so with
    no "f" or "g": y, dx and the leaves' gradients, for the cotangent dy."""
    from repro_torch.models.attention import full_attention
    from repro_torch.models.mlp import mlp_forward
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in layer.items()}
    xx = x.detach().clone().requires_grad_()
    if part == "attn":
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        y, _ = full_attention(leaves, xx, pos, cfg)
    else:
        y = mlp_forward(leaves, xx, cfg.mlp_act, cfg.d_ff)
    y.backward(dy)
    return y.detach(), xx.grad, {k: v.grad for k, v in leaves.items()}


def tp_rank_parts(cfg, state: dict, card: str) -> dict:
    """(b): layer 0 of ``state`` whole, then the part of it that
    ``shard_params`` gives the rank at each coordinate of a MeshSpec (1, nm)
    for nm in TP_RANKS (attention at 32 / nm heads, the MLP at 11008 / nm
    columns), each run alone (``tp_layer``); the ranks' y and dx summed in
    rank order (f32) and their weight gradients concatenated along the
    split dim, held to the whole layer's.  Flash's forward and backward
    timed at each rank's heads: CUDA events over 20 calls as the host
    issues them, and the device's time alone (``graph_ms`` for the
    forward, ``device_ms`` for the forward and backward)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.shardings import (model_dim, param_spec,
                                              shard_params)
    gen = torch.Generator("cuda").manual_seed(21)
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.d_model)
    dt = state["layers.attn.wq"].dtype
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dt)
    names = {part: [n for n in state if n.startswith(f"layers.{part}.")]
             for part in ("attn", "mlp")}
    zero_counts()
    out: dict = {}
    for part, leaves in names.items():
        whole = {n: state[n] for n in leaves}
        y, dx, g = tp_layer(cfg, {n.rsplit(".", 1)[1]: v[0]
                                  for n, v in whole.items()}, x, dy, part)
        for nm in TP_RANKS:
            spec = MeshSpec(("data", "model"), (1, nm))
            ys, dxs, gs = [], [], []
            for r in range(nm):
                local = shard_params(whole, spec, "tp",
                                     {"data": 0, "model": r})
                yr, dxr, gr = tp_layer(cfg, {n.rsplit(".", 1)[1]: v[0]
                                             for n, v in local.items()},
                                       x, dy, part)
                ys.append(yr.float())
                dxs.append(dxr.float())
                gs.append(gr)
                if r == 0:
                    out[f"{part} nm{nm} rank shapes"] = {
                        k: list(v.shape) for k, v in local.items()}
            errs = {"y": leaf_rel(sum(ys), y), "dx": leaf_rel(sum(dxs), dx)}
            for n in leaves:
                k = n.rsplit(".", 1)[1]
                dim = model_dim(param_spec(n, whole[n].shape, spec)) - 1
                errs[f"grad {k}"] = leaf_rel(
                    torch.cat([gr[k] for gr in gs], dim=dim), g[k])
            out[f"{part} nm{nm}"] = errs
            del ys, dxs, gs
    launches = read_counts()
    n_parts = 1 + sum(TP_RANKS)
    assert launches["flash_attn_fwd"] == n_parts and \
        launches["flash_attn_bwd"] == n_parts, launches
    for key, errs in out.items():
        if "shapes" in key:
            continue
        for k, e in errs.items():
            bound = TP_PART_REL["grad" if k.startswith("grad") else k]
            assert e <= bound, f"[tp] {key} {k}: {e:.3e} > {bound}"
    flash = {}
    for heads in (cfg.n_heads, *(cfg.n_heads // nm for nm in TP_RANKS)):
        q, k, v = (torch.randn((TRAIN_BATCH, TRAIN_SEQ, heads, cfg.head_dim),
                               generator=gen, device="cuda")
                   .to(dt).requires_grad_() for _ in range(3))
        do = torch.randn_like(q)
        fwd = time_ms(lambda: flash_attention(q.detach(), k.detach(),
                                              v.detach()), 20)

        def fwd_bwd():
            o = flash_attention(q, k, v)
            torch.autograd.grad(o, (q, k, v), do)

        flash[heads] = {
            "fwd_ms": fwd, "fwd_graph_ms": graph_ms(
                lambda: flash_attention(q.detach(), k.detach(), v.detach())),
            "fwd_bwd_ms": time_ms(fwd_bwd, 20),
            "fwd_bwd_device_ms": device_ms(fwd_bwd)}
    return {"errors": out, "launches": launches, "flash_ms": flash}


def phase_tensor_parallel(card: str, served: list | None) -> dict:
    """Phase 9 (see TP_* above).  ``served``: phase 5's greedy tokens of
    deepseek-7b without a mesh, which this phase's own unsharded engine
    must repeat (None with ``--tp-only``)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    cfg = tp_config()
    n = cfg.n_layers
    tag = f"[tp {cfg.name}]"
    state = Model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(0)).state_dict()
    gen = torch.Generator("cuda").manual_seed(22)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         device="cuda", generator=gen)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    full = get_config(TRAIN_ARCH)
    one = tp_serve(full, None, card)
    assert served is None or one["tokens"] == served, "serving not repeatable"
    ref = tp_steps(cfg, None, state, batch, card=card)
    ref.pop("model"), ref.pop("state")
    want = {"flash_attn_fwd": 2 * n * TP_STEPS, "flash_attn_bwd": n *
            TP_STEPS, "moe_gmm": 0, "moe_gmm_bwd": 0, "ssd_intra_chunk": 0,
            "ssd_intra_chunk_bwd": 0}
    assert ref["launches"] == want, (ref["launches"], want)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
            tp = tp_steps(cfg, mesh, state, batch, ref=ref, card=card)
            n_sliced = len(tp["model"].sharded)
            assert n_sliced, "no leaf sliced in tp mode"
            ckpt = tp_checkpoint(tp, mesh)
            tp.pop("model"), tp.pop("state")
            serve = tp_serve(full, mesh, card)
        finally:
            dist.destroy_process_group()
    del ref["grads"]
    assert tp["launches"] == want, (tp["launches"], want)
    bad = {k: v for k, v in tp["grads"].items() if v != 0.0}
    assert not bad, f"{tag} step-1 gradients not bit-identical: {bad}"
    assert tp["losses"] == ref["losses"] and \
        tp["grad_norms"] == ref["grad_norms"], (tp, ref)
    want_serve = {"flash_attn_fwd": full.n_layers * SERVE_REQUESTS,
                  "flash_attn_bwd": 0, "moe_gmm": 0, "moe_gmm_bwd": 0,
                  "ssd_intra_chunk": 0, "ssd_intra_chunk_bwd": 0}
    assert serve["launches"] == want_serve, serve["launches"]
    assert serve["tokens"] == one["tokens"], f"{tag} served tokens differ"
    del state
    parts = tp_rank_parts(cfg, Model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(0)).state_dict(), card)
    say(f"{tag} {n} of {full.n_layers} layers at full width "
        f"({widths(cfg)}), bf16, remat {cfg.remat}, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, {TP_STEPS} make_train_step steps (AdamW, bf16 "
        f"moments) from one state: world 1 on NCCL, a (1, 1) mesh in \"tp\""
        f" mode ({n_sliced} of {len(tp['grads'])} leaves sliced, whole at one"
        f" rank), bit-identical to the steps without a mesh in every step-1 "
        f"gradient leaf, the "
        f"losses " + ", ".join(f"{v:.6f}" for v in tp["losses"])
        + " and the grad norms " + ", ".join(f"{v:.6f}" for v in
                                            tp["grad_norms"]) + f" [{card}]")
    for key, res in (("without a mesh", ref), ("tp (1, 1)", tp)):
        groups = res.get("profile", {}).get("groups", {})
        say(f"{tag} {key}: {res['ms_per_step']:.2f} ms/step (median of "
            f"steps {TP_STEPS + 1}-{TP_STEPS + TP_TIMED_STEPS}; steps "
            + ", ".join(
                f"{t:.1f}" for t in res["step_ms"]) + " ms), launches "
            f"{res['launches']}; profiled step: NCCL kernels "
            f"{groups.get('nccl', 0.0):.3f} ms, device busy "
            f"{res.get('profile', {}).get('device_busy_ms', 0.0):.2f} ms "
            f"[{card}]")
    say(f"{tag} checkpoint of the trained state on the mesh: {ckpt['leaves']}"
        f" leaves, {ckpt['bytes'] / 1e9:.2f} GB of whole leaves written in "
        f"{ckpt['save_s']:.1f} s, restored into a fresh model in "
        f"{ckpt['restore_s']:.1f} s, every leaf bit for bit")
    say(f"{tag} served {SERVE_REQUESTS} requests at all {full.n_layers} "
        f"layers on the (1, 1) mesh: greedy tokens equal to the unsharded "
        f"engine's" + ("" if served is None else " and to phase 5's")
        + f", launches {serve['launches']}")
    for key, res in (("without a mesh", one), ("tp (1, 1)", serve)):
        prof = res["decode_profile"]
        say(f"{tag} serving {key}: drain {res['drain_s']:.2f} s, prefill "
            f"{res['prefill_ms_per_request']:.2f} ms/request, decode "
            f"{res['decode_ms_per_step']:.2f} ms/step; a profiled decode "
            f"step: wall {prof.get('wall_ms', 0.0):.2f} ms, device busy "
            f"{prof.get('device_busy_ms', 0.0):.2f} ms, NCCL kernels "
            f"{prof.get('groups', {}).get('nccl', 0.0):.3f} ms [{card}]")
    for key, errs in parts["errors"].items():
        if "shapes" in key:
            say(f"{tag} (b) {key}: {errs}")
            continue
        say(f"{tag} (b) {key}: ||sum of the ranks' parts - whole|| / "
            f"||whole|| " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f" (bounds {TP_PART_REL})")
    say(f"{tag} (b) flash at ({TRAIN_BATCH}, {TRAIN_SEQ}, H, {cfg.head_dim}) "
        f"{cfg.compute_dtype} causal, by H: " + "; ".join(
        f"{h} heads fwd {t['fwd_ms']:.4f} ms a call as issued, "
        f"{t['fwd_graph_ms']:.4f} on the device; fwd + bwd "
        f"{t['fwd_bwd_ms']:.4f} as issued, {t['fwd_bwd_device_ms']:.4f} on "
        f"the device" for h, t in parts["flash_ms"].items()) + f" [{card}]")
    paths = [{"arch": cfg.name, "n_layers": n, "path": "tp world 1 train",
              "launches": tp["launches"]},
             {"arch": full.name, "n_layers": full.n_layers,
              "path": "tp world 1 serve", "launches": serve["launches"]}]
    for res in (ref, tp):
        res.pop("grads", None)
    one.pop("tokens")
    return {"card": card, "reference": ref, "tp": tp, "checkpoint": ckpt,
            "serve_reference": one, "serve": serve, "rank_parts": parts,
            "paths": paths}


# ------------------------------------------------------------- phase 10
# the fsdp (ZeRO-3) and ZeRO-1 layouts (launch/shardings.py's fsdp_spec and
# row_axes, models/common.gather_layer, launch/collectives.gather_leaf,
# launch/steps.py, optim/adamw.py, runtime/checkpoint.py) at deepseek-7b's
# published widths: (a) world 1 on NCCL, a (1, 1) mesh, against the same
# work without a mesh: TP_STEPS make_train_step steps at WIDE_LAYERS layers
# in "fsdp" and in "tp" with ZeRO-1 moments, phase 5's requests served at
# full depth in "fsdp", the trained fsdp state checkpointed; (b) in one
# process, each rank's part at FSDP_RANKS ranks: fsdp's rows and gathered
# weights, ZeRO-1's update of each data rank's part, and the bytes of state
# each rank holds
FSDP_RANKS = (2, 4)
# (b)'s batch: FSDP_ROWS rows of TRAIN_SEQ tokens, one rank's share at 4
# ranks a row
FSDP_ROWS = 4
# (b): bounds on ||sum of the ranks' gradients / n - whole|| / ||whole||
# and on the mean of the ranks' losses against the whole batch's, in bf16,
# where each rank's gradient is rounded to bf16 before the sum: about twice
# what a sound run on the H100 gave for the gradients (2.36e-3 at 2 and 4
# ranks; the losses' mean came out equal to the whole batch's; PERF.md,
# findings)
FSDP_PART_REL = {"grad": 5e-3, "loss": 1e-5}


def state_bytes(cfg, moment_bytes: int = 2) -> dict:
    """GB of training state one rank holds at each size n of FSDP_RANKS
    (and without a mesh), from the local shapes: the parameters, their
    gradients (both ``cfg.param_dtype``) and the two AdamW moments
    (``moment_bytes`` each).  "fsdp": every leaf's ``fsdp_spec`` part over
    a (1, n) mesh; "zero1": whole parameters and gradients, the moments'
    ``zero1_spec`` parts over an (n, 1) mesh."""
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.shardings import (fsdp_spec, local_shape,
                                              param_spec, zero1_spec)
    from repro_torch.models import lm
    from repro_torch.models.api import flatten
    from repro_torch.models.common import dtype_of
    shapes = {n: tuple(p.shape) for n, p in
              flatten(lm.init_params(cfg, None, "meta")).items()}
    pb = torch.empty((), dtype=dtype_of(cfg.param_dtype)).element_size()

    def gb(parts: dict) -> float:
        return sum(math.prod(s) for s in parts.values())

    out = {"whole": (2 * pb + 2 * moment_bytes) * gb(shapes) / 1e9}
    for n in FSDP_RANKS:
        fs = MeshSpec(("data", "model"), (1, n))
        local = {k: local_shape(s, fsdp_spec(k, s, fs), fs)
                 for k, s in shapes.items()}
        out[f"fsdp {n}"] = (2 * pb + 2 * moment_bytes) * gb(local) / 1e9
        zs = MeshSpec(("data", "model"), (n, 1))
        moments = {k: local_shape(s, zero1_spec(param_spec(k, s, zs), s, zs),
                                  zs) for k, s in shapes.items()}
        out[f"zero1 {n}"] = (2 * pb * gb(shapes)
                             + 2 * moment_bytes * gb(moments)) / 1e9
    return out


def fsdp_rank_parts(cfg, state: dict) -> dict:
    """(b) on ``cfg`` (WIDE_LAYERS layers) from ``state``: for each n of
    FSDP_RANKS, every leaf's ranks' parts (``shard_params`` in "fsdp" at
    each coordinate of a MeshSpec (1, n)) concatenated in rank order, the
    gather, must be the whole leaf bit for bit; each rank's rows (FSDP_ROWS
    / n of them) run forward and backward on the whole weights, and the
    ranks' gradients, summed in rank order and divided by n, are held to
    the whole batch's within FSDP_PART_REL.  Then ZeRO-1: one AdamW step of
    every leaf (``AdamW.leaf_update``, bf16 moments drawn nonzero), whole
    and as each data rank of (n, 1) holds its ``zero1_spec`` part, the
    parts concatenated in rank order equal to the whole update bit for
    bit."""
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.shardings import (fsdp_spec, param_spec,
                                              shard_params, spec_axes,
                                              zero1_spec)
    from repro_torch.models import Model
    from repro_torch.optim import AdamW, AdamWConfig
    gen = torch.Generator("cuda").manual_seed(23)
    toks = torch.randint(0, cfg.vocab, (FSDP_ROWS, TRAIN_SEQ + 1),
                         device="cuda", generator=gen)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    model = Model(cfg, device="cuda").load_state(
        {k: v.clone() for k, v in state.items()})
    params = dict(model.named_parameters())

    def grads_of(rows: slice):
        for p in params.values():
            p.grad = None
        loss, _ = model.train_loss({k: v[rows] for k, v in batch.items()})
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone()
                                      for n, p in params.items()}

    zero_counts()
    whole_loss, whole = grads_of(slice(None))
    out: dict = {}
    for n in FSDP_RANKS:
        spec = MeshSpec(("data", "model"), (1, n))
        for name, leaf in state.items():
            s = fsdp_spec(name, leaf.shape, spec)
            dims = [d for d, e in enumerate(s) if e is not None]
            parts = [shard_params({name: leaf}, spec, "fsdp",
                                  {"data": 0, "model": r})[name]
                     for r in range(n)]
            assert len(dims) == 1 and torch.equal(
                torch.cat(parts, dim=dims[0]), leaf), f"[fsdp] gather {name}"
        size = FSDP_ROWS // n
        losses, summed = [], None
        for r in range(n):
            loss, g = grads_of(slice(r * size, (r + 1) * size))
            losses.append(loss)
            summed = {k: v.float() for k, v in g.items()} if summed is None \
                else {k: summed[k] + v.float() for k, v in g.items()}
        errs = {k: leaf_rel(summed[k] / n, whole[k].float()) for k in whole}
        out[f"fsdp {n}"] = {
            "loss": abs(float(np.mean(losses)) - whole_loss) / whole_loss,
            "grad": max(errs.values()),
            "worst_leaf": max(errs, key=errs.get)}
        del summed
    launches = read_counts()
    # each forward launches flash twice a layer (remat's recompute)
    n_calls = 1 + sum(FSDP_RANKS)
    assert launches["flash_attn_fwd"] == 2 * n_calls * cfg.n_layers and \
        launches["flash_attn_bwd"] == n_calls * cfg.n_layers, launches
    for key in [k for k in out if k.startswith("fsdp")]:
        for k in ("loss", "grad"):
            assert out[key][k] <= FSDP_PART_REL[k], \
                f"[fsdp] (b) {key} {k}: {out[key][k]:.3e} > {FSDP_PART_REL[k]}"
    opt = AdamW(AdamWConfig(warmup_steps=1, total_steps=TP_STEPS,
                            moment_dtype="bfloat16"))
    count = torch.tensor(1.0, device="cuda")
    lr = torch.tensor(opt.cfg.lr, device="cuda")
    scale = torch.tensor(0.5, device="cuda")
    for n in FSDP_RANKS:
        spec = MeshSpec(("data", "model"), (n, 1))
        split = 0
        for name, leaf in state.items():
            zs = zero1_spec(param_spec(name, leaf.shape, spec), leaf.shape,
                            spec)
            dims = [d for d, e in enumerate(zs) if "data" in
                    spec_axes((e,))]
            if not dims:
                continue
            d, split = dims[0], split + 1
            m = (1e-3 * torch.randn(leaf.shape, generator=gen,
                                    device="cuda")).to(torch.bfloat16)
            v = (1e-6 * torch.rand(leaf.shape, generator=gen,
                                   device="cuda")).to(torch.bfloat16)
            w, mw, vw = leaf.clone(), m.clone(), v.clone()
            opt.leaf_update(whole[name], mw, vw, w, scale, lr, count)
            size = leaf.shape[d] // n
            got = {"w": [], "m": [], "v": []}
            for r in range(n):
                part = (d, r * size, size)
                wr, mr, vr = (t.narrow(*part).contiguous()
                              for t in (leaf, m, v))
                opt.leaf_update(whole[name].narrow(*part), mr, vr, wr, scale,
                                lr, count)
                for k, t in (("w", wr), ("m", mr), ("v", vr)):
                    got[k].append(t)
            for k, want in (("w", w), ("m", mw), ("v", vw)):
                assert torch.equal(torch.cat(got[k], dim=d), want), \
                    f"[zero1] {name} {k} at {n} data ranks"
        out[f"zero1 {n}"] = {"leaves_split": split, "bit_identical": True}
    out["launches"] = launches
    return out


def phase_fsdp(card: str, served: list | None) -> dict:
    """Phase 10 (see FSDP_* above).  ``served``: phase 5's greedy tokens of
    deepseek-7b without a mesh (None with ``--fsdp-only``: this phase then
    serves them without a mesh itself)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    cfg = tp_config()
    n = cfg.n_layers
    tag = f"[fsdp {cfg.name}]"
    state = Model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(0)).state_dict()
    gen = torch.Generator("cuda").manual_seed(22)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         device="cuda", generator=gen)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    full = get_config(TRAIN_ARCH)
    one = None
    if served is None:
        one = tp_serve(full, None, card)
        served = one["tokens"]
    ref = tp_steps(cfg, None, state, batch, card=card)
    ref.pop("model"), ref.pop("state")
    want = {"flash_attn_fwd": 2 * n * TP_STEPS, "flash_attn_bwd": n *
            TP_STEPS, "moe_gmm": 0, "moe_gmm_bwd": 0, "ssd_intra_chunk": 0,
            "ssd_intra_chunk_bwd": 0}
    assert ref["launches"] == want, (ref["launches"], want)
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
            for key, mode, zero1 in (("fsdp", "fsdp", False),
                                     ("zero1", "tp", True)):
                res = tp_steps(cfg, mesh, state, batch, ref=ref, card=card,
                               mode=mode, zero1=zero1)
                res["sliced"] = len(res["model"].sharded)
                if key == "fsdp":
                    assert res["sliced"] == len(state), res["sliced"]
                    ckpt = tp_checkpoint(res, mesh)
                res.pop("model"), res.pop("state")
                runs[key] = res
            serve = tp_serve(full, mesh, card, mode="fsdp")
        finally:
            dist.destroy_process_group()
    for key, res in runs.items():
        assert res["launches"] == want, (key, res["launches"], want)
        bad = {k: v for k, v in res["grads"].items() if v != 0.0}
        assert not bad, f"{tag} {key}: step-1 gradients not bit-identical: " \
            f"{bad}"
        assert res["losses"] == ref["losses"] and \
            res["grad_norms"] == ref["grad_norms"], (key, res, ref)
    want_serve = {"flash_attn_fwd": full.n_layers * SERVE_REQUESTS,
                  "flash_attn_bwd": 0, "moe_gmm": 0, "moe_gmm_bwd": 0,
                  "ssd_intra_chunk": 0, "ssd_intra_chunk_bwd": 0}
    assert serve["launches"] == want_serve, serve["launches"]
    assert serve["tokens"] == served, f"{tag} served tokens differ"
    del ref["grads"]
    parts = fsdp_rank_parts(cfg, state)
    del state
    held = state_bytes(full)
    say(f"{tag} {n} of {full.n_layers} layers at full width "
        f"({widths(cfg)}), bf16, remat {cfg.remat}, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, {TP_STEPS} make_train_step steps (AdamW, bf16 "
        f"moments) from one state, world 1 on NCCL, a (1, 1) mesh: \"fsdp\" "
        f"({runs['fsdp']['sliced']} of {len(runs['fsdp']['grads'])} leaves "
        f"sliced, whole at one rank, gathered a layer at a time) and \"tp\" "
        f"with ZeRO-1 moments, each bit-identical to the steps without a "
        f"mesh in every step-1 gradient leaf, the losses " + ", ".join(
            f"{v:.6f}" for v in ref["losses"]) + " and the grad norms "
        + ", ".join(f"{v:.6f}" for v in ref["grad_norms"]) + f" [{card}]")
    for key, res in (("without a mesh", ref), ("fsdp (1, 1)", runs["fsdp"]),
                     ("tp + ZeRO-1 (1, 1)", runs["zero1"])):
        prof = res.get("profile", {})
        say(f"{tag} {key}: {res['ms_per_step']:.2f} ms/step (median of "
            f"steps {TP_STEPS + 1}-{TP_STEPS + TP_TIMED_STEPS}; steps "
            + ", ".join(f"{t:.1f}" for t in res["step_ms"]) + " ms), peak "
            f"{res['max_memory_allocated_gb']:.2f} GB, launches "
            f"{res['launches']}; profiled step: NCCL kernels "
            f"{prof.get('groups', {}).get('nccl', 0.0):.3f} ms, device busy "
            f"{prof.get('device_busy_ms', 0.0):.2f} ms of wall "
            f"{prof.get('wall_ms', 0.0):.2f} ms [{card}]")
    say(f"{tag} checkpoint of the trained fsdp state on the mesh: "
        f"{ckpt['leaves']} leaves, {ckpt['bytes'] / 1e9:.2f} GB of whole "
        f"leaves written in {ckpt['save_s']:.1f} s, restored into a fresh "
        f"model in {ckpt['restore_s']:.1f} s, every leaf bit for bit")
    say(f"{tag} served {SERVE_REQUESTS} requests at all {full.n_layers} "
        f"layers in \"fsdp\" on the (1, 1) mesh: greedy tokens equal to "
        f"phase 5's" + (" (served here without a mesh)" if one else "")
        + f", launches {serve['launches']}")
    prof = serve["decode_profile"]
    say(f"{tag} serving fsdp (1, 1): drain {serve['drain_s']:.2f} s, prefill "
        f"{serve['prefill_ms_per_request']:.2f} ms/request, decode "
        f"{serve['decode_ms_per_step']:.2f} ms/step; a profiled decode step: "
        f"wall {prof.get('wall_ms', 0.0):.2f} ms, device busy "
        f"{prof.get('device_busy_ms', 0.0):.2f} ms, NCCL kernels "
        f"{prof.get('groups', {}).get('nccl', 0.0):.3f} ms [{card}]")
    for key, errs in parts.items():
        if key != "launches":
            say(f"{tag} (b) {key}: {errs}" + (
                f" (bounds {FSDP_PART_REL})" if key.startswith("fsdp")
                else ""))
    say(f"{tag} (b) GB of training state a rank holds at {full.name}'s "
        f"{full.n_layers} layers (bf16 parameters, gradients and two bf16 "
        f"moments, from the local shapes): " + ", ".join(
            f"{k} {v:.2f}" for k, v in held.items()))
    paths = [{"arch": cfg.name, "n_layers": n, "path": f"{key} world 1 train",
              "launches": runs[key]["launches"]} for key in runs]
    paths += [{"arch": full.name, "n_layers": full.n_layers,
               "path": "fsdp world 1 serve", "launches": serve["launches"]},
              {"arch": cfg.name, "n_layers": n, "path": "fsdp rank parts",
               "launches": parts.pop("launches")}]
    for res in runs.values():
        res.pop("grads", None)
    serve.pop("tokens")
    if one is not None:
        one.pop("tokens")
    return {"card": card, "reference": ref, **runs, "checkpoint": ckpt,
            "serve": serve, "serve_reference": one, "rank_parts": parts,
            "state_gb": held, "paths": paths}


# ------------------------------------------------------------- phase 11
# the sequence split of an "fsdp" batch smaller than the mesh
# (launch/shardings.split_batch, models/attention.py's keys and values gathered
# over the sequence's axes, models/ssm.py's conv halo and state pass,
# launch/collectives.seq_halo).  The machine has one card, and at world 1
# every batch divides the mesh, so the split never occurs on NCCL here: in
# one process, each rank's part of one layer at published widths on 1 x
# SEQ_TOKENS tokens, cut as each of SEQ_RANKS sequence ranks holds it, runs
# the port's own layer code with the sequence's collectives done among the
# ranks in turn (SeqRanks), against the whole layer
SEQ_RANKS = (2, 4)
SEQ_TOKENS = 4096
SEQ_SSM_ARCH = MAMBA2
# bounds on ||the ranks' parts joined - whole|| / ||whole|| in bf16: y and
# dx concatenated in rank order, the weight gradients summed in rank order
# (f32), the keys' and values' gradients as each rank's backward got them
# (its own share and the later ranks', summed in bf16) concatenated.
# About twice what a sound run on the H100 gave (PERF.md, findings): dx
# 8.64e-4, the weight gradients 4.51e-3 (each rank's rounded to bf16
# before the sum), dk and dv 2.99e-3; y came out bit-identical to the
# whole layer's, which no bound requires
SEQ_PART_REL = {"y": 1e-3, "dx": 2e-3, "grad": 1e-2, "dkv": 6e-3}
# bounds on ||a rank's prefill output - the whole prompt's|| / ||whole||
# in bf16 (lm.prefill of the one-layer model): the last logits and every
# cache leaf but pos, which is exact
SEQ_PREFILL_REL = {"logits": 1e-2, "k": 1e-2, "v": 1e-2, "conv": 1e-2,
                   "ssm": 2e-2}


class _SeqRankGather(torch.autograd.Function):
    """``gather_leaf`` among the ranks of a ``SeqRanks``: the rank's part
    joined with the other ranks' recorded ones in rank order; backward,
    the rank's part of the gradient plus what the later ranks' backwards
    sent it, and the earlier ranks' parts sent to them."""

    @staticmethod
    def forward(ctx, x, dim, ranks, call):
        ctx.dim, ctx.ranks, ctx.call, ctx.rank = dim, ranks, call, ranks.rank
        parts = list(ranks.parts[call])
        parts[ranks.rank] = x
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        ranks, r = ctx.ranks, ctx.rank
        sent = ranks.sent.setdefault(ctx.call, [None] * ranks.n)
        chunks = grad.chunk(ranks.n, ctx.dim)
        for j, c in enumerate(chunks):
            if j > r:        # a later rank, already run: causality says 0
                ranks.late = max(ranks.late, float(c.abs().max()))
            elif j < r:
                sent[j] = c.clone() if sent[j] is None else sent[j] + c
        own = chunks[r] if sent[r] is None else chunks[r] + sent[r]
        ranks.total.setdefault(ctx.call, [None] * ranks.n)[r] = own.detach()
        return own.contiguous(), None, None, None


class SeqRanks:
    """The collectives of a sequence split over ``n`` ranks, the ranks run
    one after another in this process.  Under ``patched()``, the layer
    code's ``seq_split`` says that rank ``rank`` of ``n`` runs, and its
    ``gather_leaf`` (the keys and values, the conv's halo, the state pass)
    joins the ranks' parts in rank order.  Each call's parts are recorded
    on a pass of every rank in rank order without autograd (``enter(r,
    record=True)``); on the pass with autograd, in reverse rank order, the
    gather's backward adds to the rank's part the gradient the later
    ranks' backwards sent it (a reduce-scatter's sum) and sends the
    earlier ranks theirs; what reaches a later rank must be 0 (``late``,
    the largest such value)."""

    def __init__(self, n: int):
        self.n, self.rank, self.call, self.record = n, 0, 0, True
        self.parts: dict = {}
        self.sent: dict = {}
        self.total: dict = {}
        self.late = 0.0

    def enter(self, rank: int, record: bool) -> None:
        self.rank, self.record, self.call = rank, record, 0

    def split(self):
        return (None, ("seq",), self.rank, self.n)

    def gather(self, x, mesh, dim: int, axes="model"):
        call, self.call = self.call, self.call + 1
        parts = self.parts.setdefault(call, [None] * self.n)
        if not self.record:
            return _SeqRankGather.apply(x, dim, self, call)
        parts[self.rank] = x.detach().clone()
        return torch.cat([torch.zeros_like(x) if p is None else p
                          for p in parts], dim)

    def patched(self):
        from contextlib import ExitStack
        from unittest import mock

        import repro_torch.launch.collectives as collectives
        import repro_torch.models.attention as attention
        import repro_torch.models.lm as lm
        import repro_torch.models.ssm as ssm
        stack = ExitStack()
        for mod in (collectives, attention, ssm):
            stack.enter_context(mock.patch.object(mod, "gather_leaf",
                                                  self.gather))
        for mod in (attention, ssm, lm):
            stack.enter_context(mock.patch.object(mod, "seq_split",
                                                  self.split))
        return stack


def seq_layer_run(layer, leaves: dict, x, dy):
    """``layer(leaves, x)`` forward and backward for the cotangent ``dy``:
    y, dx and the leaves' gradients."""
    lv = {k: v.detach().requires_grad_() for k, v in leaves.items()}
    xx = x.detach().clone().requires_grad_()
    y = layer(lv, xx)
    grads = torch.autograd.grad(y, [xx, *lv.values()], dy)
    return y.detach(), grads[0], dict(zip(lv, grads[1:]))


def seq_rank_parts(layer, leaves: dict, x, dy, n: int,
                   whole: tuple, kv_calls: tuple = ()) -> dict:
    """The ``n`` ranks' parts of ``layer`` on ``x`` (1, S, D) (rank r
    holds tokens [r S/n, (r+1) S/n)) through ``SeqRanks``: their y and dx
    concatenated in rank order and their weight gradients summed in rank
    order, each held to ``whole`` (y, dx, gradients of the whole layer);
    the gradients each rank's backward got for the gathers ``kv_calls``
    (the keys and values), concatenated, against ``whole``'s fourth entry
    (the same of one rank)."""
    s = x.shape[1] // n
    ranks = SeqRanks(n)
    ys, dxs, summed = [None] * n, [None] * n, None
    with ranks.patched():
        for r in range(n):
            ranks.enter(r, record=True)
            with torch.no_grad():
                layer(leaves, x[:, r * s:(r + 1) * s])
        for r in reversed(range(n)):
            ranks.enter(r, record=False)
            ys[r], dxs[r], g = seq_layer_run(
                layer, leaves, x[:, r * s:(r + 1) * s],
                dy[:, r * s:(r + 1) * s])
            g = {k: v.float() for k, v in g.items()}
            summed = g if summed is None else \
                {k: g[k] + summed[k] for k in g}
    y, dx, grads = whole[:3]
    errs = {"y": leaf_rel(torch.cat(ys, dim=1), y),
            "dx": leaf_rel(torch.cat(dxs, dim=1), dx)}
    worst = {k: leaf_rel(summed[k], grads[k]) for k in grads}
    errs["grad"] = max(worst.values())
    errs["worst_leaf"] = max(worst, key=worst.get)
    for call, name in zip(kv_calls, ("dk", "dv")):
        errs[name] = leaf_rel(torch.cat(ranks.total[call], dim=1),
                              whole[3][call])
    errs["late"] = ranks.late
    return errs


def seq_layers():
    """Layer 0 of deepseek-7b and of mamba2-780m at their published widths
    (bf16, seed 0), each as (cfg, the one-layer model's parameters, its
    layer's leaves, layer(leaves, x) -> y: the port's pre-norm block with
    its residuals, at the positions ``lm.seq_positions`` gives the rank
    that runs it)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, lm
    from repro_torch.models.api import _unflatten
    out = {}
    for arch in (TRAIN_ARCH, SEQ_SSM_ARCH):
        cfg = get_config(arch).replace(n_layers=1)
        model = Model(cfg, device="cuda").init(
            torch.Generator("cuda").manual_seed(0))
        leaves = {k[len("layers."):]: v[0] for k, v in
                  model.state_dict().items() if k.startswith("layers.")}
        if cfg.family == "ssm":
            def layer(lv, x, cfg=cfg):
                return lm._mamba_layer(_unflatten(lv), x, cfg, False)[0]
        else:
            def layer(lv, x, cfg=cfg):
                pos = lm.seq_positions(x.shape[1], x.device)
                return lm._block_forward(_unflatten(lv), x, pos, 0, cfg)[0]
        out[arch] = (cfg, model.params, leaves, layer)
    return out


def seq_prefill_parts(cfg, params, tokens, n: int, whole: tuple) -> dict:
    """``lm.prefill`` of ``tokens`` (1, S) as each of ``n`` sequence ranks
    holds them (rank r tokens [r S/n, (r+1) S/n)) through ``SeqRanks``,
    without autograd: the ranks run in rank order twice, the first pass
    recording each rank's parts of the gathers, so that on the second every
    rank reads every other's.  Each rank's last logits and cache, from the
    port's own positions, ``seq_last`` and mamba prefill cache, against
    ``whole`` (the whole prompt's): the worst relative error of each
    output over the ranks, and whether every rank's pos equals the
    whole's."""
    from repro_torch.models import lm
    s = tokens.shape[1] // n
    ranks = SeqRanks(n)
    want_logits, want_cache = whole
    errs: dict = {}
    pos_equal = True
    with ranks.patched(), torch.no_grad():
        for check in (False, True):
            for r in range(n):
                ranks.enter(r, record=True)
                logits, cache = lm.prefill(
                    params, {"tokens": tokens[:, r * s:(r + 1) * s]}, cfg)
                if not check:
                    continue
                got = {"logits": logits, **cache}
                for k, want in {"logits": want_logits,
                                **want_cache}.items():
                    if k == "pos":
                        pos_equal &= torch.equal(got[k], want)
                        continue
                    errs[k] = max(errs.get(k, 0.0), leaf_rel(got[k], want))
    errs["pos_equal"] = pos_equal
    return errs


def seq_state_pass_ms(cfg, s: int, n: int, gen) -> dict:
    """The state pass alone at a rank's slice of ``s`` tokens: the
    rank's ``ssd_chunked`` (its SSD launch at s / chunk chunks and the
    inter-chunk glue) with an incoming state added (``carry`` returning a
    fixed state, as the fold over the gathered states gives it; rank n-1's
    fold over n-1 states timed beside it) and without: CUDA events over 20
    calls as the host issues them, and the device's time alone
    (``graph_ms``)."""
    from repro_torch.models.ssm import _carry, ssd_chunked
    h, p, nn_ = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xh = torch.randn((1, s, h, p), generator=gen,
                     device="cuda").to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn(
        (1, s, h), generator=gen, device="cuda"))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    bm, cm = (torch.randn((1, s, nn_), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    h_in = torch.randn((1, h, nn_, p), generator=gen, device="cuda")
    hs = torch.randn((n, 1, h, nn_, p), generator=gen, device="cuda")
    decays = torch.rand((n, 1, h), generator=gen, device="cuda")
    ranks = SeqRanks(n)
    ranks.parts = {0: list(hs[:, None].unbind(0)),
                   1: list(decays[:, None].unbind(0))}
    fold = _carry(None, ("seq",), n - 1, n)

    def folded():
        ranks.enter(n - 1, record=False)
        return fold(hs[-1], decays[-1])

    def plain():
        return ssd_chunked(xh, dt, a_log, bm, cm, cfg.ssm_chunk)

    def carried():
        return ssd_chunked(xh, dt, a_log, bm, cm, cfg.ssm_chunk,
                           carry=lambda hh, aa: h_in)

    out = {"tokens": s, "chunks": -(-s // cfg.ssm_chunk)}
    with torch.no_grad():
        for key, fn in (("ssd_chunked", plain), ("with_state", carried)):
            out[f"{key}_ms"] = time_ms(fn, 20)
            out[f"{key}_graph_ms"] = graph_ms(fn)
        with ranks.patched():
            out["fold_ms"] = time_ms(folded, 20)
            out["fold_graph_ms"] = graph_ms(folded)
    out["state_add_graph_ms"] = out["with_state_graph_ms"] - \
        out["ssd_chunked_graph_ms"]
    return out


def seq_kernel_ms(cfg_dense, cfg_ssm, gen) -> dict:
    """Flash's forward and forward + backward at each rank's (S, T) = (s,
    (r+1) s) for s = SEQ_TOKENS / n (bf16, deepseek-7b's 32 heads x 128),
    and the SSD kernel's forward and forward + backward at each rank's
    chunks (mamba2-780m's 48 heads x 64, state 128): CUDA events over 20
    calls, and the device's time of the forward (``graph_ms``) and of the
    forward and backward (``device_ms``)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd import ssd_intra_chunk
    h, hd = cfg_dense.n_heads, cfg_dense.head_dim
    flash, ssd = {}, {}
    for n in (1, *SEQ_RANKS):
        s = SEQ_TOKENS // n
        for r in range(n):
            q, k, v = (torch.randn((1, t, h, hd), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       .requires_grad_() for t in (s, (r + 1) * s,
                                                   (r + 1) * s))
            do = torch.randn_like(q)

            def fwd_bwd():
                o = flash_attention(q, k, v)
                torch.autograd.grad(o, (q, k, v), do)

            flash[f"n{n} r{r} S{s} T{(r + 1) * s}"] = {
                "fwd_ms": time_ms(lambda: flash_attention(
                    q.detach(), k.detach(), v.detach()), 20),
                "fwd_graph_ms": graph_ms(lambda: flash_attention(
                    q.detach(), k.detach(), v.detach())),
                "fwd_bwd_ms": time_ms(fwd_bwd, 20),
                "fwd_bwd_device_ms": device_ms(fwd_bwd)}
        shape = (1, s // cfg_ssm.ssm_chunk, cfg_ssm.ssm_chunk,
                 cfg_ssm.ssm_heads, cfg_ssm.ssm_head_dim, cfg_ssm.ssm_state)
        x = ssd_inputs(*shape, True, gen)
        dy, ds = ssd_cotangents(shape, "both", gen)
        ssd[f"n{n} chunks {shape[1]}"] = {
            "shape": list(shape),
            "fwd_ms": time_ms(lambda: ssd_intra_chunk(*x), 20),
            "fwd_graph_ms": graph_ms(lambda: ssd_intra_chunk(*x)),
            "fwd_bwd_ms": time_ms(lambda: ssd_grads(x, dy, ds), 20),
            "fwd_bwd_device_ms": device_ms(lambda: ssd_grads(x, dy, ds))}
    return {"flash": flash, "ssd": ssd}


# phase 11's second part: the families whose sequence split carries a
# second layout, at published widths in bf16 on 1 x SEQ_TOKENS positions,
# the ranks in threads of this process (SeqThreads): llama4-scout's MoE
# layer 0 (the all-to-all path on each rank's slice, at a capacity factor
# that drops nothing, E / k, against the whole layer, and at its own 1.25
# against the dense dispatch of each slice alone, the slice's capacity
# 160 at 2 ranks and 80 at 4); whisper-medium's encoder and decoder layers
# on 1500 frames + 448 tokens, and the prefill of a one-plus-one-layer
# model, its frames split as its tokens and whole beside them; llava-next's
# embedding, layer 0 and text CE (the one-layer model's train_loss) on
# 2880 patches + 1216 tokens, and its prefill, then on 2878 patches whole
SEQ_MOE_NO_DROP_CF = 16.0          # llama4-scout's E / k
SEQ_WHISPER = (1500, 448)          # frames, decoder tokens
SEQ_LLAVA = (2880, 1216)           # patches, tokens: 4096 positions
# llava-next with patches that no split divides, so they lie whole on every
# rank beside the tokens split over SEQ_LLAVA_WHOLE_RANKS: 2878 + 1216 =
# 4094 positions in slices of 1024, the last rank's 1022 real and 2 pads
# (models/lm.py::_embed); flash runs at each rank's (1024, (r+1) 1024)
SEQ_LLAVA_WHOLE = (2878, 1216)
SEQ_LLAVA_WHOLE_RANKS = 4
# bounds on ||the ranks' parts joined - whole|| / ||whole|| in bf16 (the
# gradients summed over the ranks; a prefill's worst rank), about twice
# what a sound run on the H100 gave (PERF.md, findings, PR 29): the MoE's
# dx 2.0e-10 (held at 1e-6), experts' gradients 1.90e-5, router's
# 1.42e-6; whisper's dx 1.61e-3, the encoder output's gradient 5.24e-3,
# weight gradients 5.44e-3; llava's gradients 5.77e-3.  y, aux, the
# slices' y, llava's loss and every prefill came out bit-identical, which
# no bound requires: y keeps SEQ_PART_REL's 1e-3, the prefills
# SEQ_PREFILL_REL's 1e-2, and aux and llava's loss (f32 sums) the CPU
# tests' 1e-6 and 1e-5
SEQ_FAMILY_REL = {
    LLAMA4: {"y": 1e-3, "aux": 1e-6, "dx": 1e-6, "grad": 4e-5,
             "router": 3e-6, "slices": 1e-3},
    WHISPER: {"y": 1e-3, "dx": 4e-3, "denc": 1.1e-2, "grad": 1.1e-2,
              "logits": 1e-2, "cache": 1e-2},
    LLAVA: {"loss": 1e-5, "grad": 1.2e-2, "logits": 1e-2, "cache": 1e-2}}


class SeqThreads:
    """The ranks of a sequence split over the ``n`` ranks of "model", each
    in a thread of this process, one at a time: a rank runs until its next
    collective (``exchange``), then the next rank does, so that at each
    collective every rank's part is there.  The collectives are
    differentiable torch ops on the ranks' parts (``gather_leaf`` a cat,
    ``all_to_all`` a cat of each rank's share of every rank's tensor,
    ``all_reduce`` a sum), so one backward from the main thread over every
    rank's output runs every rank's backward and each collective's as its
    transpose, as the port's do across processes.  Under ``patched`` the
    port's code sees a (1, n) mesh of ("data", "model") in "fsdp" mode
    with the sequence over "model" (``common.use_mesh``; its leaves whole,
    so ``fsdp_mesh`` is None) and the batch leaves ``whole`` whole."""

    def __init__(self, n: int):
        import threading
        self.n, self.turn, self.parts, self.failed = n, 0, {}, None
        self.cond = threading.Condition()
        self.local = threading.local()

    def _wait(self, r: int) -> None:
        self.sems[r].acquire()
        if self.failed is not None:
            raise RuntimeError("another rank failed")

    def _pass(self, r: int) -> None:
        """The turn to the next rank, waking only its thread."""
        self.turn = (r + 1) % self.n
        self.sems[self.turn].release()

    def run(self, fn) -> list:
        """``fn(rank)`` in each rank's thread, in turns (with grad as the
        calling thread has it); the results in rank order."""
        import threading
        out = [None] * self.n
        grad = torch.is_grad_enabled()
        self.turn, self.parts, self.failed = 0, {}, None
        self.sems = [threading.Semaphore(0) for _ in range(self.n)]
        self.sems[0].release()

        def body(r):
            self.local.rank, self.local.call = r, 0
            try:
                self._wait(r)
                with torch.set_grad_enabled(grad):
                    out[r] = fn(r)
            except BaseException as e:      # noqa: BLE001 (re-raised below)
                with self.cond:
                    self.failed = self.failed or e
                for sem in self.sems:       # every waiting rank sees it
                    sem.release()
                return
            self._pass(r)

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            if t.is_alive():
                raise RuntimeError("[seq] a rank hung at a collective")
        if self.failed is not None:
            raise self.failed
        return out

    def exchange(self, x) -> list:
        """Every rank's ``x`` of this collective, in rank order."""
        from repro_torch.models import common
        r = self.local.rank
        call, self.local.call = self.local.call, self.local.call + 1
        self.parts.setdefault(call, [None] * self.n)[r] = x
        ambient = common._AMBIENT[0]
        self._pass(r)
        self._wait(r)
        common._AMBIENT[0] = ambient
        return self.parts[call]

    def gather(self, x, mesh, dim: int, axes="model"):
        return torch.cat(self.exchange(x), dim)

    def all_to_all(self, x, mesh, axis: str, split_dim: int,
                   concat_dim: int):
        r = self.local.rank
        return torch.cat([p.chunk(self.n, split_dim)[r]
                          for p in self.exchange(x)], concat_dim)

    def all_reduce(self, x, mesh, axes, grad_scale: float = 1.0):
        return torch.stack(self.exchange(x)).sum(dim=0)

    def seq_rank(self, mesh, axes, coord=None):
        return (self.local.rank, self.n) if axes else (0, 1)

    def patched(self, whole: tuple = ()):
        from contextlib import ExitStack
        from unittest import mock

        import repro_torch.launch.collectives as collectives
        from repro_torch.launch.mesh import MeshSpec
        from repro_torch.models import attention, common, encdec, lm, mlp, ssm
        stack = ExitStack()
        for mod in (collectives, attention, ssm, mlp, encdec, lm):
            stack.enter_context(mock.patch.object(mod, "gather_leaf",
                                                  self.gather))
        for name in ("all_to_all", "all_reduce"):
            stack.enter_context(mock.patch.object(mlp, name,
                                                  getattr(self, name)))
        stack.enter_context(mock.patch.object(common, "seq_rank",
                                              self.seq_rank))
        stack.enter_context(mock.patch.object(common, "fsdp_mesh",
                                              lambda: None))
        stack.enter_context(common.use_mesh(
            MeshSpec(("data", "model"), (1, self.n)), "fsdp", rows=(),
            seq=("model",), whole=whole))
        return stack


def seq_family_model(arch: str, **over):
    """The published config of ``arch`` with ``over`` replaced and remat
    off (the phase's backward runs outside the ranks' threads), bf16, seed
    0 on the card: (cfg, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(arch).replace(remat="none", **over)
    model = Model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(0))
    return cfg, model.params


def seq_errs(got: dict, want: dict) -> dict:
    """leaf_rel of each of ``got`` against ``want``; a dict of tensors is
    held by its worst leaf (``worst_leaf`` names it)."""
    errs = {}
    for k, g in got.items():
        if isinstance(g, dict):
            by = {n: leaf_rel(g[n], want[k][n]) for n in g}
            errs[k] = max(by.values())
            errs[f"worst_{k}"] = max(by, key=by.get)
        else:
            errs[k] = leaf_rel(g, want[k])
    return errs


def seq_hold(tag: str, errs: dict, bounds: dict) -> None:
    bad = {k: v for k, v in errs.items() if k in bounds and v > bounds[k]}
    assert not bad, f"[seq] {tag} {bad}: {errs} > {bounds}"


def seq_moe(gen) -> dict:
    """llama4-scout's MoE layer 0 at published widths (router and 16
    experts, top-1) on 1 x SEQ_TOKENS tokens: y, dx and the experts'
    gradients through y, and aux and the router's gradient through aux
    (top-1's combine weight is p / p = 1, so the router's gradient through
    y is rounding noise), of each n of SEQ_RANKS ranks (each rank its slice
    and its 16 / n experts; a rank's experts' gradients are its slices of
    the leaves, the router's summed, each rank's aux weighing 1 / n)
    against the whole layer's at E / k; then at the config's own capacity
    factor each rank's y against the dense dispatch of its slice alone."""
    from repro_torch.configs import get_config
    from repro_torch.models.mlp import (init_moe_params, moe_capacity,
                                        moe_forward)
    cfg = get_config(LLAMA4).replace(n_layers=1)
    nodrop = cfg.replace(capacity_factor=SEQ_MOE_NO_DROP_CF)
    leaves = init_moe_params(torch.Generator("cuda").manual_seed(0), cfg,
                             torch.bfloat16, "cuda")
    shape = (1, SEQ_TOKENS, cfg.d_model)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    lv = {k: v.detach().requires_grad_() for k, v in leaves.items()}
    experts = {k: v for k, v in lv.items() if k != "router"}

    def grads(ys, auxes, xx, dys):
        g = torch.autograd.grad(ys, [xx, *experts.values()], dys,
                                retain_graph=True)
        router, = torch.autograd.grad(torch.stack(auxes).mean(),
                                      [lv["router"]])
        return {"y": torch.cat([y.detach() for y in ys], 1),
                "aux": auxes[0].detach(), "dx": g[0],
                "grad": dict(zip(experts, g[1:])), "router": router}

    xx = x.detach().clone().requires_grad_()
    y, aux = moe_forward(lv, xx, nodrop)
    whole = grads([y], [aux], xx, [dy])
    out = {}
    for n in SEQ_RANKS:
        e = cfg.n_experts // n
        ranks = SeqThreads(n)
        xx = x.detach().clone().requires_grad_()
        xs, dys = xx.chunk(n, 1), dy.chunk(n, 1)

        def own(r, e=e):
            return {k: v if k == "router" else v[r * e:(r + 1) * e]
                    for k, v in lv.items()}

        with ranks.patched():
            res = ranks.run(lambda r, xs=xs: moe_forward(own(r), xs[r],
                                                         nodrop))
        auxes = [r_[1] for r_ in res]
        errs = seq_errs(grads([r_[0] for r_ in res], auxes, xx, dys), whole)
        errs["aux_alike"] = all(torch.equal(auxes[0], a) for a in auxes)
        with ranks.patched(), torch.no_grad():
            res = ranks.run(lambda r, xs=xs: moe_forward(
                own(r), xs[r].detach(), cfg))
        with torch.no_grad():
            want = [moe_forward(lv, s.detach(), cfg)[0] for s in xs]
        errs["slices"] = max(leaf_rel(g[0], w) for g, w in zip(res, want))
        errs["capacity"] = moe_capacity(cfg, SEQ_TOKENS // n)
        out[f"n{n}"] = errs
        assert errs["aux_alike"], f"[seq] moe n{n}: {errs}"
        seq_hold(f"moe n{n}", errs, SEQ_FAMILY_REL[LLAMA4])
    return out


def seq_layer_parts(layer, lv: dict, x, dy, shared: dict | None = None,
                    n: int = 1) -> dict:
    """``layer(lv, x, *shared)`` forward and backward for the cotangent
    ``dy``: whole (``n`` 1, no mesh) or as ``n`` sequence ranks hold x
    (SeqThreads), every rank reading the same ``shared`` tensors.  y and dx
    joined in rank order, the gradients of ``shared`` ("d" + name) and of
    the leaves (``grad``) summed over the ranks by the one backward."""
    shared = shared or {}
    xx = x.detach().clone().requires_grad_()
    sh = {k: v.detach().clone().requires_grad_() for k, v in shared.items()}
    if n == 1:
        ys, dys = [layer(lv, xx, *sh.values())], [dy]
    else:
        ranks = SeqThreads(n)
        xs, dys = xx.chunk(n, 1), dy.chunk(n, 1)
        with ranks.patched():
            ys = ranks.run(lambda r: layer(lv, xs[r], *sh.values()))
    grads = torch.autograd.grad(ys, [xx, *sh.values(), *lv.values()], dys)
    out = {"y": torch.cat([y.detach() for y in ys], 1), "dx": grads[0]}
    out.update({f"d{k}": g for k, g in zip(sh, grads[1:])})
    out["grad"] = dict(zip(lv, grads[1 + len(sh):]))
    return out


def seq_prefill_ranks(prefill, batch: dict, n: int, split: tuple,
                      whole: tuple = ()) -> list:
    """``prefill(batch_r)`` of each of ``n`` sequence ranks in SeqThreads
    without autograd, rank r given its slice of each leaf of ``split``
    (dim 1) and the others whole; ``whole`` names the leaves that the
    port is told lie whole."""
    parts = {k: v.chunk(n, 1) if k in split else [v] * n
             for k, v in batch.items()}
    ranks = SeqThreads(n)
    with ranks.patched(whole), torch.no_grad():
        return ranks.run(lambda r: prefill({k: v[r]
                                            for k, v in parts.items()}))


def seq_prefill_errs(got: list, want: tuple) -> dict:
    """The worst relative error over the ranks of each of the last logits
    and the cache's leaves against the whole prompt's ``want``, and
    whether every rank's pos equals it."""
    want_logits, want_cache = want
    errs: dict = {"pos_equal": True}
    for logits, cache in got:
        for k, w in {"logits": want_logits, **want_cache}.items():
            g = logits if k == "logits" else cache[k]
            if k == "pos":
                errs["pos_equal"] &= torch.equal(g, w)
                continue
            errs[k] = max(errs.get(k, 0.0), leaf_rel(g, w))
    errs["cache"] = max(v for k, v in errs.items()
                        if k not in ("logits", "pos_equal"))
    return errs


def seq_leaves(tree: dict) -> dict:
    """Copies of a layer's leaves that require grad, by dotted name."""
    from repro_torch.models.api import flatten
    return {k: v.detach().clone().requires_grad_()
            for k, v in flatten(tree).items()}


def seq_whisper(gen) -> dict:
    """whisper-medium at published widths, one encoder and one decoder
    layer, bf16, on 1 x (1500 frames + 448 tokens): its encoder layer (each
    rank's frames at their positions, non-causal over every frame) and its
    decoder layer (causal over the earlier ranks' tokens, cross-attention
    over every frame: the encoder output read by every rank, its gradient
    summed) against the whole layers at each n of SEQ_RANKS; then
    ``encdec.prefill`` of the model, its frames split as the tokens are and
    whole beside them, every rank's last logits and cache against the
    whole prompt's."""
    from repro_torch.models import encdec
    from repro_torch.models.api import _unflatten
    from repro_torch.models.lm import _layer, seq_positions
    cfg, params = seq_family_model(WHISPER, n_layers=1, enc_layers=1)
    t, s = SEQ_WHISPER

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def enc_layer(lv, x):
        return encdec._enc_layer(_unflatten(lv), x,
                                 seq_positions(x.shape[1], x.device), cfg)

    def dec_layer(lv, x, enc_out):
        return encdec._dec_layer(_unflatten(lv), x,
                                 seq_positions(x.shape[1], x.device),
                                 enc_out, cfg)[0]

    cases = {"encoder": (enc_layer, seq_leaves(_layer(params["enc_layers"],
                                                      0)),
                         draw(1, t, cfg.d_model), draw(1, t, cfg.d_model),
                         None),
             "decoder": (dec_layer, seq_leaves(_layer(params["dec_layers"],
                                                      0)),
                         draw(1, s, cfg.d_model), draw(1, s, cfg.d_model),
                         {"enc": draw(1, t, cfg.d_model)})}
    out: dict = {}
    for key, (layer, lv, x, dy, shared) in cases.items():
        whole = seq_layer_parts(layer, lv, x, dy, shared)
        for n in SEQ_RANKS:
            errs = seq_errs(seq_layer_parts(layer, lv, x, dy, shared, n),
                            whole)
            out[f"{key} n{n}"] = errs
            seq_hold(f"whisper {key} n{n}", errs, SEQ_FAMILY_REL[WHISPER])
        del whole
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, s), generator=gen,
                                     device="cuda"),
             "frames": 0.1 * torch.randn((1, t, cfg.d_model), generator=gen,
                                         device="cuda")}

    def prefill(b):
        return encdec.prefill(params, b, cfg)

    with torch.no_grad():
        want = prefill(batch)
    for n in SEQ_RANKS:
        for frames, split, whole in (("split", ("tokens", "frames"), ()),
                                     ("whole", ("tokens",), ("frames",))):
            errs = seq_prefill_errs(seq_prefill_ranks(
                prefill, batch, n, split, whole), want)
            out[f"prefill n{n} frames {frames}"] = errs
            assert errs["pos_equal"], f"[seq] whisper prefill n{n}: {errs}"
            seq_hold(f"whisper prefill n{n} frames {frames}", errs,
                     SEQ_FAMILY_REL[WHISPER])
    return out


def seq_llava(gen) -> dict:
    """llava-next at published widths cut to one layer, bf16, on 1 x (2880
    patches + 1216 tokens) = 4096 positions: ``lm.train_loss`` (the
    projected patches and the embeddings joined and cut into each rank's
    contiguous slice, layer 0, the head on the rank's text positions and
    its CE summed over them over its count of labels) of each n of
    SEQ_RANKS ranks, the mean of the ranks' losses and its gradients in
    every leaf against the whole batch's; then ``lm.prefill``, every rank's
    last logits and cache against the whole prompt's."""
    from repro_torch.models import lm
    from repro_torch.models.api import flatten
    cfg, params = seq_family_model(LLAVA, n_layers=1)
    p, s = SEQ_LLAVA
    toks = torch.randint(0, cfg.vocab, (1, s + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "patches": 0.1 * torch.randn((1, p, lm.PATCH_DIM),
                                          generator=gen, device="cuda")}
    leaves = flatten(params)
    loss = lm.train_loss(params, batch, cfg)[0]
    whole = {"loss": loss.detach(),
             "grad": dict(zip(leaves, torch.autograd.grad(
                 loss, list(leaves.values()))))}
    out: dict = {}
    for n in SEQ_RANKS:
        parts = {k: v.chunk(n, 1) for k, v in batch.items()}
        ranks = SeqThreads(n)
        with ranks.patched():
            losses = ranks.run(lambda r: lm.train_loss(
                params, {k: v[r] for k, v in parts.items()}, cfg)[0])
        loss = torch.stack(losses).sum() / n
        errs = seq_errs({"loss": loss.detach(), "grad": dict(zip(
            leaves, torch.autograd.grad(loss, list(leaves.values()))))},
            whole)
        size = (p + s) // n
        errs["text_positions"] = [min(size, max(0, (r + 1) * size - p))
                                  for r in range(n)]
        out[f"n{n}"] = errs
        seq_hold(f"llava n{n}", errs, SEQ_FAMILY_REL[LLAVA])
    del whole
    pre = {k: v for k, v in batch.items() if k != "labels"}

    def prefill(b):
        return lm.prefill(params, b, cfg)

    with torch.no_grad():
        want = prefill(pre)
    for n in SEQ_RANKS:
        errs = seq_prefill_errs(seq_prefill_ranks(
            prefill, pre, n, ("tokens", "patches")), want)
        out[f"prefill n{n}"] = errs
        assert errs["pos_equal"], f"[seq] llava prefill n{n}: {errs}"
        seq_hold(f"llava prefill n{n}", errs, SEQ_FAMILY_REL[LLAVA])
    return out


def seq_llava_whole(gen) -> dict:
    """llava-next at published widths cut to one layer, bf16, on 1 x (2878
    patches + 1216 tokens) = 4094 positions over SEQ_LLAVA_WHOLE_RANKS
    ranks, the patches whole on every rank (``common.batch_split``): the
    joined sequence padded at its tail to 4 x 1024 (``lm._embed``).
    ``lm.train_loss`` of each rank, the mean of the ranks' losses and its
    gradients in every leaf, and ``lm.prefill``, every rank's last logits
    (the holder of position 4093's) and cache (cut to 4094 positions),
    against the whole batch's; the (q, k) shapes at which each rank's
    attention called flash."""
    from unittest import mock

    from repro_torch.models import attention, lm
    from repro_torch.models.api import flatten
    cfg, params = seq_family_model(LLAVA, n_layers=1)
    (p, s), n = SEQ_LLAVA_WHOLE, SEQ_LLAVA_WHOLE_RANKS
    toks = torch.randint(0, cfg.vocab, (1, s + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "patches": 0.1 * torch.randn((1, p, lm.PATCH_DIM),
                                          generator=gen, device="cuda")}
    leaves = flatten(params)
    loss = lm.train_loss(params, batch, cfg)[0]
    whole = {"loss": loss.detach(),
             "grad": dict(zip(leaves, torch.autograd.grad(
                 loss, list(leaves.values()))))}
    parts = {k: [v] * n if k == "patches" else v.chunk(n, 1)
             for k, v in batch.items()}
    shapes: set = set()
    flash = attention.flash_attention

    def recorded(q, k, *args, **kw):
        shapes.add((tuple(q.shape), tuple(k.shape)))
        return flash(q, k, *args, **kw)

    ranks = SeqThreads(n)
    with ranks.patched(whole=("patches",)), \
            mock.patch.object(attention, "flash_attention", recorded):
        losses = ranks.run(lambda r: lm.train_loss(
            params, {k: v[r] for k, v in parts.items()}, cfg)[0])
    loss = torch.stack(losses).sum() / n
    errs = seq_errs({"loss": loss.detach(), "grad": dict(zip(
        leaves, torch.autograd.grad(loss, list(leaves.values()))))}, whole)
    del whole
    size = -(-(p + s) // n)
    errs["pads"] = size * n - (p + s)
    errs["text_positions"] = [min(size, max(0, min((r + 1) * size, p + s)
                                            - max(r * size, p)))
                              for r in range(n)]
    want_shapes = {((1, size, cfg.n_heads, cfg.head_dim),
                    (1, (r + 1) * size, cfg.n_kv_heads, cfg.head_dim))
                   for r in range(n)}
    assert shapes == want_shapes, (shapes, want_shapes)
    errs["flash_shapes"] = sorted(shapes)
    seq_hold(f"llava whole patches n{n}", errs, SEQ_FAMILY_REL[LLAVA])
    out: dict = {f"n{n}": errs}
    pre = {k: v for k, v in batch.items() if k != "labels"}

    def prefill(b):
        return lm.prefill(params, b, cfg)

    with torch.no_grad():
        want = prefill(pre)
    errs = seq_prefill_errs(seq_prefill_ranks(
        prefill, pre, n, ("tokens",), whole=("patches",)), want)
    out[f"prefill n{n}"] = errs
    assert errs["pos_equal"], f"[seq] llava whole prefill n{n}: {errs}"
    seq_hold(f"llava whole prefill n{n}", errs, SEQ_FAMILY_REL[LLAVA])
    return out


def seq_family_kernel_ms(gen) -> dict:
    """Flash at each rank's shapes of this part (bf16): whisper's encoder
    (S = 1500 / n non-causal against T = 1500 frames, 16 heads x 64), its
    cross-attention (448 / n rows against 1500 frames) and llava's layer
    (4096 / n rows, 32 heads on 8 kv x 128, causal against T = (r + 1) S);
    and the grouped FFN at each rank's experts, (1, 16 / n, n C, 5120,
    8192) swiglu with C the slice's capacity at 1.25 (every row filled):
    forward (graph) and forward + backward (device) ms, n = 1 the whole."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import grouped_ffn
    from repro_torch.models.mlp import moe_capacity
    t, s = SEQ_WHISPER
    flash, gmm = {}, {}
    for n in (1, *SEQ_RANKS):
        shapes = {f"whisper encoder n{n}": (t // n, t, 16, 16, 64, False),
                  f"whisper cross n{n}": (s // n, t, 16, 16, 64, False)}
        size = SEQ_TOKENS // n
        shapes.update({f"llava n{n} r{r}": (size, (r + 1) * size, 32, 8,
                                            128, True) for r in range(n)})
        for key, (sq, tk, h, k, hd, causal) in shapes.items():
            q, kk, v = (x.requires_grad_() for x in
                        qkv(1, sq, tk, h, k, hd, torch.bfloat16, gen))
            do = torch.randn_like(q)

            def fwd(q=q, kk=kk, v=v, causal=causal):
                return flash_attention(q.detach(), kk.detach(), v.detach(),
                                       causal=causal)

            def fwd_bwd(q=q, kk=kk, v=v, do=do, causal=causal):
                o = flash_attention(q, kk, v, causal=causal)
                torch.autograd.grad(o, (q, kk, v), do)

            flash[key] = {"shape": [1, sq, tk, h, k, hd], "causal": causal,
                          "fwd_graph_ms": graph_ms(fwd),
                          "fwd_bwd_device_ms": device_ms(fwd_bwd)}
        cfg = get_config(LLAMA4)
        c = moe_capacity(cfg, SEQ_TOKENS // n)
        shape = (1, cfg.n_experts // n, n * c, cfg.d_model, cfg.d_ff)
        *ops, dy = gmm_bwd_inputs(shape, "swiglu", torch.bfloat16, None,
                                  gen)
        ops = [x.requires_grad_() for x in ops]

        def gmm_fwd_bwd(ops=ops, dy=dy):
            torch.autograd.grad(grouped_ffn(*ops, act="swiglu"), ops, dy)

        gmm[f"n{n}"] = {
            "shape": list(shape),
            "fwd_graph_ms": graph_ms(lambda ops=ops: grouped_ffn(
                *[x.detach() for x in ops], act="swiglu")),
            "fwd_bwd_device_ms": device_ms(gmm_fwd_bwd, iters=5)}
    return {"flash": flash, "gmm": gmm}


# the launches of phase 11's second part: llama4's MoE (the whole layer's
# forward and backward; per n, each rank's forward and backward without
# drops, each rank's forward at 1.25 and each slice's dense dispatch);
# whisper (the whole encoder and decoder layers' 1 + 2 forwards and
# backwards and the whole prefill's 3; per n, each rank's, and each
# rank's prefill with its frames split and whole); llava (the whole train
# step's and prefill's one a layer; per n each rank's), and so with its
# patches whole at SEQ_LLAVA_WHOLE_RANKS ranks
LLAVA_WHOLE = f"{LLAVA} (patches whole)"
def seq_family_launches() -> dict:
    ranks = sum(SEQ_RANKS)
    zero = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "moe_gmm": 0,
            "moe_gmm_bwd": 0, "ssd_intra_chunk": 0,
            "ssd_intra_chunk_bwd": 0}
    return {
        LLAMA4: {**zero, "moe_gmm": 1 + 3 * ranks,
                 "moe_gmm_bwd": 1 + ranks},
        WHISPER: {**zero, "flash_attn_fwd": 6 + 9 * ranks,
                  "flash_attn_bwd": 3 + 3 * ranks},
        LLAVA: {**zero, "flash_attn_fwd": 2 + 2 * ranks,
                "flash_attn_bwd": 1 + ranks},
        LLAVA_WHOLE: {**zero, "flash_attn_fwd": 2 + 2 * SEQ_LLAVA_WHOLE_RANKS,
                      "flash_attn_bwd": 1 + SEQ_LLAVA_WHOLE_RANKS}}


def phase_seq_families(card: str, gen) -> dict:
    """Phase 11's second part (see SEQ_MOE_NO_DROP_CF above): llama4-
    scout's MoE layer, whisper's layers and prefill, llava's train_loss
    and prefill (its patches split, then whole), each rank's part against
    the whole, every launch counted from 0 a family; then the kernels timed
    at the ranks' shapes."""
    errors, paths = {}, []
    want = seq_family_launches()
    tag = "[seq]"
    for key_, arch, run in ((LLAMA4, LLAMA4, seq_moe),
                            (WHISPER, WHISPER, seq_whisper),
                            (LLAVA, LLAVA, seq_llava),
                            (LLAVA_WHOLE, LLAVA, seq_llava_whole)):
        zero_counts()
        t0 = time.perf_counter()
        errors[key_] = run(gen)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for key, errs in errors[key_].items():
            say(f"{tag} {key_} {key} (bf16): " + ", ".join(
                f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                for k, v in errs.items())
                + f" (bounds {SEQ_FAMILY_REL[arch]})")
        launches = read_counts()
        say(f"{tag} {key_}: {seconds:.2f} s, launches {launches}")
        assert launches == want[key_], (key_, launches, want[key_])
        paths.append({"arch": arch, "n_layers": 1,
                      "path": "sequence-split family parts" + (
                          ", patches whole" if key_ == LLAVA_WHOLE else ""),
                      "launches": launches, "seconds": seconds})
        gc.collect()
        torch.cuda.empty_cache()
    timed = seq_family_kernel_ms(gen)
    for key, t in timed["flash"].items():
        say(f"{tag} flash {key} {t['shape']} causal {t['causal']}: forward "
            f"(graph) {t['fwd_graph_ms']:.4f} ms, forward + backward "
            f"(device) {t['fwd_bwd_device_ms']:.4f} ms [{card}]")
    for key, t in timed["gmm"].items():
        say(f"{tag} grouped FFN {key} {t['shape']}: forward (graph) "
            f"{t['fwd_graph_ms']:.4f} ms, forward + backward (device) "
            f"{t['fwd_bwd_device_ms']:.4f} ms [{card}]")
    return {"errors": errors, "timed": timed, "paths": paths}


def phase_seq_split(card: str) -> dict:
    """Phase 11 (see SEQ_* above): for deepseek-7b's and mamba2-780m's
    layer 0 at published widths, the whole layer on 1 x SEQ_TOKENS tokens,
    then each rank's part at each n of SEQ_RANKS (``seq_rank_parts``), every
    launch counted from 0; then the kernels timed at each rank's shapes and
    the state pass alone; then the MoE, whisper and llava
    (``phase_seq_families``)."""
    from repro_torch.models import lm
    layers = seq_layers()
    gen = torch.Generator("cuda").manual_seed(24)
    out: dict = {}
    prefill: dict = {}
    paths = []
    for arch, (cfg, params, leaves, layer) in layers.items():
        shape = (1, SEQ_TOKENS, cfg.d_model)
        x = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        dense = cfg.family == "dense"
        zero_counts()
        whole = seq_layer_run(layer, leaves, x, dy)
        if dense:          # the keys' and values' gradients of one rank
            one = SeqRanks(1)
            with one.patched():
                one.enter(0, record=True)
                with torch.no_grad():
                    layer(leaves, x)
                one.enter(0, record=False)
                seq_layer_run(layer, leaves, x, dy)
            whole = (*whole, {c: one.total[c][0] for c in (0, 1)})
        for n in SEQ_RANKS:
            errs = seq_rank_parts(layer, leaves, x, dy, n, whole,
                                  (0, 1) if dense else ())
            out[f"{arch} n{n}"] = errs
            assert errs["late"] == 0.0, f"[seq] {arch} n{n}: {errs}"
            for k in SEQ_PART_REL:
                if k == "dkv":
                    bad = [e for e in ("dk", "dv") if e in errs
                           and errs[e] > SEQ_PART_REL[k]]
                else:
                    bad = [k] if errs[k] > SEQ_PART_REL[k] else []
                assert not bad, \
                    f"[seq] {arch} n{n} {bad}: {errs} > {SEQ_PART_REL}"
        launches = read_counts()
        # the whole layer; each rank's forward without autograd (the
        # recorded pass) and with it, and its backward; deepseek's one-rank
        # pass for the keys' gradients besides
        calls = 1 + sum(SEQ_RANKS)
        fwd = 1 + 2 * sum(SEQ_RANKS) + (2 if dense else 0)
        want = {"flash_attn_fwd": fwd if dense else 0,
                "flash_attn_bwd": calls + 1 if dense else 0,
                "moe_gmm": 0, "moe_gmm_bwd": 0,
                "ssd_intra_chunk": 0 if dense else fwd,
                "ssd_intra_chunk_bwd": 0 if dense else calls}
        assert launches == want, (arch, launches, want)
        paths.append({"arch": cfg.name, "n_layers": 1,
                      "path": "sequence-split rank parts",
                      "launches": launches})
        tokens = torch.randint(0, cfg.vocab, (1, SEQ_TOKENS), generator=gen,
                               device="cuda")
        zero_counts()
        with torch.no_grad():
            whole = lm.prefill(params, {"tokens": tokens}, cfg)
        for n in SEQ_RANKS:
            errs = seq_prefill_parts(cfg, params, tokens, n, whole)
            prefill[f"{arch} n{n}"] = errs
            assert errs["pos_equal"], f"[seq] prefill {arch} n{n}: {errs}"
            bad = {k: v for k, v in errs.items()
                   if k in SEQ_PREFILL_REL and v > SEQ_PREFILL_REL[k]}
            assert not bad, \
                f"[seq] prefill {arch} n{n} {bad} > {SEQ_PREFILL_REL}"
        launches = read_counts()
        # the whole prompt, and each rank's twice
        fwd = 1 + 2 * sum(SEQ_RANKS)
        want = {"flash_attn_fwd": fwd if dense else 0, "flash_attn_bwd": 0,
                "moe_gmm": 0, "moe_gmm_bwd": 0,
                "ssd_intra_chunk": 0 if dense else fwd,
                "ssd_intra_chunk_bwd": 0}
        assert launches == want, (arch, launches, want)
        paths.append({"arch": cfg.name, "n_layers": 1,
                      "path": "sequence-split prefill",
                      "launches": launches})
        del whole
    (dcfg, *_), (scfg, *_) = layers.values()
    del layers
    timed = seq_kernel_ms(dcfg, scfg, gen)
    state = {f"n{n}": seq_state_pass_ms(scfg, SEQ_TOKENS // n, n, gen)
             for n in SEQ_RANKS}
    tag = "[seq]"
    for key, errs in out.items():
        say(f"{tag} {key} ({SEQ_TOKENS} tokens, bf16): " + ", ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in errs.items()) + f" (bounds {SEQ_PART_REL})")
    for key, errs in prefill.items():
        say(f"{tag} prefill {key} ({SEQ_TOKENS} tokens, bf16): " + ", ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
            for k, v in errs.items()) + f" (bounds {SEQ_PREFILL_REL})")
    for key, t in timed["flash"].items():
        say(f"{tag} flash {key}: forward {t['fwd_ms']:.4f} ms (graph "
            f"{t['fwd_graph_ms']:.4f}), forward + backward "
            f"{t['fwd_bwd_ms']:.4f} ms (device {t['fwd_bwd_device_ms']:.4f})"
            f" [{card}]")
    for n in SEQ_RANKS:
        ranks_ms = [timed["flash"][k]["fwd_bwd_device_ms"]
                    for k in timed["flash"] if k.startswith(f"n{n} ")]
        say(f"{tag} flash at {n} ranks: the last rank's forward + backward "
            f"{ranks_ms[-1] / (sum(ranks_ms) / n):.3f} x the mean rank's "
            f"(device) [{card}]")
    for key, t in timed["ssd"].items():
        say(f"{tag} SSD {key} {t['shape']}: forward {t['fwd_ms']:.4f} ms "
            f"(graph {t['fwd_graph_ms']:.4f}), forward + backward "
            f"{t['fwd_bwd_ms']:.4f} ms (device {t['fwd_bwd_device_ms']:.4f})"
            f" [{card}]")
    for key, t in state.items():
        say(f"{tag} state pass {key}: ssd_chunked at {t['tokens']} tokens "
            f"({t['chunks']} chunks) {t['ssd_chunked_ms']:.4f} ms (graph "
            f"{t['ssd_chunked_graph_ms']:.4f}), with the incoming state "
            f"added {t['with_state_ms']:.4f} ms (graph "
            f"{t['with_state_graph_ms']:.4f}, +"
            f"{t['state_add_graph_ms']:.4f}); the last rank's fold "
            f"{t['fold_ms']:.4f} ms (graph {t['fold_graph_ms']:.4f}) "
            f"[{card}]")
    families = phase_seq_families(card, gen)
    return {"card": card, "errors": out, "prefill_errors": prefill,
            "timed": timed, "state_pass": state,
            "families": {k: families[k] for k in ("errors", "timed")},
            "paths": paths + families["paths"]}


# ------------------------------------------------------------- phase 12
# the mesh dry run: (arch, shape, multi-pod, mode) of each cell of (a), at
# the published configs and full depth
MESH_CELLS = [("deepseek-7b", shape, multi_pod, mode)
              for shape in ("train_4k", "prefill_32k", "decode_32k")
              for multi_pod in (False, True) for mode in ("tp", "fsdp")] + [
    (LLAMA4, "train_4k", False, "fsdp"),
    (MAMBA2, "prefill_32k", False, "fsdp"),
    (WHISPER, "train_4k", True, "fsdp"),
    ("gemma3-27b", "long_500k", False, "tp"),
    ("gemma3-27b", "long_500k", False, "fsdp"),
    (MAMBA2, "long_500k", False, "tp"),
    (ZAMBA2, "long_500k", False, "tp")]
# (b): the training steps counted at world 1 on the card and on meta, and
# the decode steps held against no mesh
WORLD_ONE_STEPS = (("deepseek fsdp", "fsdp", False),
                   ("deepseek tp + ZeRO-1", "tp", True),
                   ("llama4 fsdp", "fsdp", False))
MESH_DECODE_ROWS, MESH_DECODE_PROMPT, MESH_DECODE_STEPS = 4, 64, 4
MESH_TIMEOUT = 600


def world_one_step(key: str, mesh, device: str) -> dict:
    """One ``make_train_step`` step of WORLD_ONE_STEPS' ``key`` on the
    (1, 1) ``mesh`` on ``device`` ("cuda": seed-0 weights and tokens;
    "meta": shapes alone, over a fake world), counted: the collectives by
    kind and axis, and the launches on the card."""
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.roofline import Counter
    mode, zero1 = {k: (m, z) for k, m, z in WORLD_ONE_STEPS}[key]
    cfg = ep_config() if key.startswith("llama4") else tp_config()
    set_sharding_mode(mode)
    try:
        model = Model(cfg, device=device, mesh=mesh)
    finally:
        set_sharding_mode("tp")
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    if device == "meta":
        batch = {k: torch.empty(shape, dtype=torch.int64, device="meta")
                 for k in ("tokens", "labels")}
    else:
        model.init(torch.Generator("cuda").manual_seed(0))
        gen = torch.Generator("cuda").manual_seed(21)
        toks = torch.randint(0, cfg.vocab, (shape[0], shape[1] + 1),
                             device="cuda", generator=gen)
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
    opt = AdamW(AdamWConfig(moment_dtype="bfloat16"))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params, model, zero1=zero1)}
    step = make_train_step(model, opt)
    zero_counts()
    with Counter(device, mesh) as c:
        step(state, batch)
    s = c.summary()
    return {"layers": cfg.n_layers, "launches": read_counts(),
            **{k: s[k] for k in ("collective_calls", "collective_counts",
                                 "collective_by_axis", "flops")}}


def world_one_meta(out: str) -> int:
    """(b)'s meta side, run as ``chip_smoke.py --world-one-meta OUT`` in a
    process of its own: each step of WORLD_ONE_STEPS counted on meta over
    a fake world of one, into OUT (JSON)."""
    from repro_torch.launch.mesh import MeshSpec, fake_world
    res = {}
    with fake_world(MeshSpec(("data", "model"), (1, 1))) as mesh:
        for key, _, _ in WORLD_ONE_STEPS:
            res[key] = world_one_step(key, mesh, "meta")
            res[key].pop("launches")
    Path(out).write_text(json.dumps(res))
    return 0


def mesh_decode(mesh, rows: int = MESH_DECODE_ROWS) -> dict:
    """deepseek-7b's 2 layers at full width: a prefill of ``rows`` random
    prompts without a mesh, then MESH_DECODE_STEPS
    ``make_serve_step`` steps from its cache without a mesh and on the
    (1, 1) ``mesh`` in each mode (the whole tokens and the rank's part of
    the cache, ``Model.cache_part``): {layout: (tokens, cache)}."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    cfg = tp_config()
    state = Model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(0)).state_dict()
    gen = torch.Generator("cuda").manual_seed(23)
    prompts = torch.randint(0, cfg.vocab, (rows, MESH_DECODE_PROMPT),
                            device="cuda", generator=gen)
    whole = Model(cfg, device="cuda").load_state(
        {k: v.clone() for k, v in state.items()})
    logits, cache0 = whole.prefill(
        {"tokens": prompts}, pad_to=MESH_DECODE_PROMPT + MESH_DECODE_STEPS)
    tok0 = whole.greedy(logits)[:, None]
    out = {}
    for layout, m, mode in (("none", None, "tp"), ("tp", mesh, "tp"),
                            ("fsdp", mesh, "fsdp")):
        set_sharding_mode(mode)
        try:
            model = whole if m is None else Model(
                cfg, device="cuda", mesh=m).load_state(
                    {k: v.clone() for k, v in state.items()})
        finally:
            set_sharding_mode("tp")
        cache = model.cache_part({k: v.clone() for k, v in cache0.items()})
        step, tok, toks = make_serve_step(model), tok0, []
        with torch.no_grad():
            for _ in range(MESH_DECODE_STEPS):
                tok, cache = step(tok, cache)
                toks.append(tok)
        out[layout] = (torch.cat(toks, dim=1), cache)
    return out


def mesh_row_line(r: dict) -> str:
    rep, mem, c = r["roofline"], r["memory"], r["counts"]
    return (f"{r['arch']} x {r['shape']} on {r['mesh']} "
            f"{r['sharding_mode']}, rank {r['rank']} ({r['n_layers']} "
            f"layers; rows over {r['layout']['rows']}, sequence over "
            f"{r['layout']['seq']}): compute {rep['compute_s'] * 1e3:.2f} "
            f"ms, memory {rep['memory_s'] * 1e3:.2f} ms, collective "
            f"{rep['collective_s'] * 1e3:.2f} ms at NVLink's rate ("
            + ", ".join(f"{a} {v * 1e3:.2f}" for a, v in
                        r["collective_s_by_axis"].items())
            + f" by axis), bound {r['bound_s'] * 1e3:.2f} ms; link GB by "
            "kind " + ", ".join(
                f"{k} {v / 1e9:.3f} ({c['collective_counts'][k]} calls)"
                for k, v in c["collective_by_kind"].items())
            + "; by axis " + ", ".join(
                f"{a} {v / 1e9:.3f}" for a, v in
                c["collective_by_axis"].items())
            + f"; peak {mem['peak_bytes'] / 1e9:.2f} GB, "
            + ("fits" if mem["fits"] else "does not fit") + " 80 GB")


def phase_mesh_dryrun(card: str) -> dict:
    """Phase 12 (see MESH_CELLS and WORLD_ONE_STEPS above)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    tag = "[mesh dry run]"
    t0 = time.perf_counter()
    out = ROOT / "chiprun_out" / "mesh_dryrun"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(kernel_model.__file__).resolve().parents[2]),
         os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--multi-pod", "on" if multi_pod else "off",
         "--sharding-mode", mode, "--out", str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, shape, multi_pod, mode in MESH_CELLS]
    meta_json = out / "world_one_meta.json"
    procs.append(subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--world-one-meta",
         str(meta_json)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    try:
        # (b) on the card while the cells count
        with tempfile.TemporaryDirectory() as d:
            dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                    rank=0, world_size=1)
            try:
                mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
                card_steps = {}
                for key, _, _ in WORLD_ONE_STEPS:
                    card_steps[key] = world_one_step(key, mesh, "cuda")
                    gc.collect()
                    torch.cuda.empty_cache()
                zero_counts()
                decoded = mesh_decode(mesh)
                decode_launches = read_counts()
            finally:
                dist.destroy_process_group()
        for p in procs:
            _, err = p.communicate(timeout=MESH_TIMEOUT)
            assert p.returncode == 0, f"{tag} {p.args}: {err[-3000:]}"
    finally:
        for p in procs:
            p.kill()
    rows = []
    for arch, shape, multi_pod, mode in MESH_CELLS:
        mesh_tag = "2x16x16" if multi_pod else "16x16"
        row = json.loads((out / f"{arch}__{shape}__{mesh_tag}__{mode}.json")
                         .read_text())
        assert row["status"] == "ok", (arch, shape, mesh_tag, mode, row)
        rows.append(row)
        say(f"{tag} (a) {mesh_row_line(row)} (data-sheet estimate)")
    meta_steps = json.loads(meta_json.read_text())
    zero_ln = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "moe_gmm": 0,
               "moe_gmm_bwd": 0, "ssd_intra_chunk": 0,
               "ssd_intra_chunk_bwd": 0}
    paths = []
    for key, res in card_steps.items():
        meta = meta_steps[key]
        for k in ("collective_calls", "collective_counts",
                  "collective_by_axis"):
            assert res[k] == meta[k], f"{tag} {key}: {k} card {res[k]} " \
                f"meta {meta[k]}"
        n = res["layers"]
        want = {**zero_ln, "flash_attn_fwd": 2 * n, "flash_attn_bwd": n}
        if key.startswith("llama4"):
            want.update(moe_gmm=2 * n, moe_gmm_bwd=n)
        assert res["launches"] == want, (key, res["launches"], want)
        say(f"{tag} (b) {key}, {n} layers, one step at world 1 on NCCL, a "
            f"(1, 1) mesh: the card's collective calls by kind and axis "
            f"equal the meta count's over a fake world of one: "
            f"{res['collective_calls']}; FLOPs card {res['flops']} meta "
            f"{meta['flops']}; launches {res['launches']} [{card}]")
        paths.append({"arch": LLAMA4 if key.startswith("llama4")
                      else TRAIN_ARCH, "n_layers": n,
                      "path": f"mesh dry run (b) {key}",
                      "launches": res["launches"]})
    ref_tok, ref_cache = decoded.pop("none")
    for layout, (toks, cache) in decoded.items():
        assert torch.equal(toks, ref_tok), f"{tag} {layout}: tokens differ"
        for k, v in ref_cache.items():
            assert torch.equal(cache[k], v), f"{tag} {layout}: cache {k}"
    n = tp_config().n_layers
    want = {**zero_ln, "flash_attn_fwd": n}
    assert decode_launches == want, (decode_launches, want)
    say(f"{tag} (b) make_serve_step of deepseek-7b's {n} layers at full "
        f"width on the (1, 1) mesh, \"tp\" and \"fsdp\", the whole tokens "
        f"and the rank's part of the cache: {MESH_DECODE_STEPS} steps of "
        f"{MESH_DECODE_ROWS} rows, tokens and cache bit for bit against no "
        f"mesh ({ref_tok[0].tolist()} ...) [{card}]")
    paths.append({"arch": TRAIN_ARCH, "n_layers": n,
                  "path": "mesh dry run (b) serve", "launches":
                  decode_launches})
    wall = time.perf_counter() - t0
    say(f"{tag} phase 12: {len(rows)} cells ok, {wall:.1f} s")
    return {"cells": rows, "world_one": {"card": card_steps,
                                         "meta": meta_steps},
            "wall_s": wall, "paths": paths}


# ------------------------------------------------------------- phase 13
# context-parallel decode of a batch of one: gemma3-27b at its published
# widths cut to CP_LAYERS of its 62 layers (5 windowed layers of 1024, then
# 1 global), long_500k's T positions over the CP_RANKS ranks of (16, 16)'s
# data axis, pos CP_BACK before the end of T, so that every rank but the
# last holds no position of the windowed layers
CP_ARCH, CP_LAYERS, CP_T, CP_RANKS = "gemma3-27b", 6, 524288, 16
CP_STEPS, CP_BACK = 4, 8
# (c): deepseek-7b's 2 layers at decode_32k, the rank's 8 rows of 128 on
# (16, 16), its kv heads over the 16 ranks of "model"
CP_HEADS_LAYERS, CP_HEADS_ROWS, CP_HEADS_T = 2, 8, 32768
# leaf_rel bounds of bf16 against the whole cache's bf16: y and the
# written k/v rows of a layer fed the same input, and the logits after
# the layers (each layer's y from other roundings feeds the next)
CP_REL = {"y": 1e-2, "rows": 2e-2, "logits": 3e-2}


class CpThreads(SeqThreads):
    """``SeqThreads`` over one axis of a mesh of ("data", "model"): the
    ``n`` ranks of ``axis``, one of size 1 beside it (``mesh``).  The
    collectives over ``axis`` gather (``gather_leaf``, so
    ``collectives.gather_parts``) or sum (``all_reduce``, in rank order)
    the ranks' tensors; over the other axis they are the identity, as on
    one rank.  Under ``patched`` the port's code sees that mesh in ``mode``
    with its leaves whole (``fsdp_mesh`` None; in "tp" mode one rank of
    "model" holds them whole) and the decode cache's leaves ``cache``
    ((leaf, axes), ...) split over positions; given ``model`` (its leaves
    whole), the model is on that mesh in ``mode``, so that its entry points
    run as a rank's."""

    def __init__(self, n: int, axis: str):
        from repro_torch.launch.mesh import MeshSpec
        super().__init__(n)
        self.axis = axis
        self.mesh = MeshSpec(("data", "model"),
                             (n, 1) if axis == "data" else (1, n))

    def _on(self, axes) -> bool:
        return self.axis in ((axes,) if isinstance(axes, str) else
                             tuple(axes))

    def gather(self, x, mesh, dim: int, axes="model"):
        return torch.cat(self.exchange(x), dim) if self._on(axes) else x

    def all_reduce(self, x, mesh, axes, grad_scale: float = 1.0):
        if not self._on(axes):
            return x
        parts = self.exchange(x)
        out = parts[0]
        for p in parts[1:]:            # in rank order
            out = out + p
        return out

    def seq_rank(self, mesh, axes, coord=None):
        return (self.local.rank, self.n) if self._on(axes) else (0, 1)

    def coordinate(self, mesh) -> dict:
        return {a: self.local.rank if a == self.axis else 0
                for a in ("data", "model")}

    def patched(self, cache: tuple = (), mode: str = "fsdp", model=None):
        from contextlib import ExitStack
        from unittest import mock

        import repro_torch.launch.collectives as collectives
        from repro_torch.launch import shardings
        from repro_torch.models import api, attention, common, lm, mlp
        stack = ExitStack()
        patches = [(collectives, "gather_leaf", self.gather),
                   (common, "seq_rank", self.seq_rank),
                   (common, "fsdp_mesh", lambda: None)]
        patches += [(mod, "coordinate", self.coordinate)
                    for mod in (shardings, api, attention, lm, mlp)]
        patches += [(mod, name, fn) for mod in (attention, lm, mlp)
                    for name, fn in (("all_reduce", self.all_reduce),
                                     ("copy_to", lambda x, mesh, axis: x),
                                     ("gather_leaf", self.gather))]
        if self.axis == "data":        # the vocabulary whole on one rank
            patches.append((api, "vocab_argmax",
                            lambda x, mesh: torch.argmax(x, dim=-1)))
        for mod, name, fn in patches:
            stack.enter_context(mock.patch.object(mod, name, fn))
        if model is not None:
            prev = model.mesh, model.mode
            model.mesh, model.mode = self.mesh, mode

            def restore():
                model.mesh, model.mode = prev
            stack.callback(restore)
        stack.enter_context(common.use_mesh(self.mesh, mode, rows=(),
                                            cache=cache))
        return stack


def cp_kv(shape, gen) -> tuple:
    """A bf16 decode cache's k and v of ``shape`` drawn from ``gen``."""
    return tuple(torch.randn(shape, dtype=torch.bfloat16, device="cuda",
                             generator=gen) for _ in range(2))


def cp_slices(x: torch.Tensor, n: int, dim: int) -> list:
    """The n contiguous parts of ``x`` along ``dim``, views."""
    return list(x.chunk(n, dim=dim))


def cp_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``torch.equal`` one slice of dim 0 at a time (a cache of tens of GB
    would need as many bytes again at once)."""
    return a.shape == b.shape and all(torch.equal(x, y)
                                      for x, y in zip(a, b))


def cp_layer_hold(tag: str, lp, x, whole: tuple, parts: tuple, pos, cfg,
                  window: int, threads: CpThreads, dim: int) -> dict:
    """One decode attention layer fed ``x``: on the whole cache ``whole``
    (k, v: (B, T, K, hd)) without a mesh, and on ``parts`` (k, v; the same
    values) cut into the threads' ranks along ``dim`` (1: positions, 2: kv
    heads), each rank's ``decode_attention`` under ``threads.patched``.  Holds
    every rank's y alike, within CP_REL of the whole's, and returns the
    errors."""
    from repro_torch.models import attention
    y_whole, _ = attention.decode_attention(lp, x, whole[0], whole[1], pos,
                                            cfg, window=window)
    ks, vs = (cp_slices(t, threads.n, dim) for t in parts)
    cache = (("k", ("data",)),) if threads.axis == "data" else ()
    with threads.patched(cache):
        ys = threads.run(lambda r: attention.decode_attention(
            lp, x, ks[r], vs[r], pos, cfg, window=window)[0])
    for r, y in enumerate(ys):
        assert torch.equal(y, ys[0]), f"{tag}: rank {r}'s y differs"
    err = leaf_rel(ys[0], y_whole)
    assert torch.isfinite(ys[0]).all() and err < CP_REL["y"], (tag, err)
    return {"y": err}


def cp_serve(model, threads: CpThreads, mode: str, cache: dict,
             toks) -> list:
    """``make_serve_step(model)`` on the threads' mesh in ``mode``, each
    rank in its thread: its cache ``Model.cache_part``'s of the whole
    ``cache`` (its own ``pos``: a leaf the part does not split is the
    whole's, and the ranks share one process), ``toks[s]`` fed at step s.
    Per rank: (each step's logits, the greedy tokens, the final part)."""
    from unittest import mock

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import lm
    real, logits = lm.decode_step, [[] for _ in range(threads.n)]

    def spy(*args, **kw):
        out = real(*args, **kw)
        logits[threads.local.rank].append(out[0])
        return out

    def rank(r):
        part = model.cache_part(cache)
        part["pos"] = part["pos"].clone()
        step, out = make_serve_step(model), []
        for tok in toks:
            got, part = step(tok, part)
            out.append(got)
        return torch.cat(out, dim=1), part

    with torch.no_grad(), threads.patched(mode=mode, model=model), \
            mock.patch.object(lm, "decode_step", spy):
        parts = threads.run(rank)
    return [(logits[r], *parts[r]) for r in range(threads.n)]


def cp_gemma(card: str, gen) -> dict:
    """(a): gemma3-27b's CP_LAYERS layers at T = CP_T, CP_STEPS steps."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.models import Model, attention, lm
    tag = "[context parallel] (a)"
    cfg = get_config(CP_ARCH).replace(n_layers=CP_LAYERS)
    windows = [lm._window(cfg, i) for i in range(CP_LAYERS)]
    assert windows == [cfg.sliding_window] * 5 + [0], windows
    n, t = CP_RANKS, CP_T
    assert CP_STEPS <= CP_BACK and \
        t - CP_BACK - cfg.sliding_window >= t - t // n
    model = Model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(0))
    params = model.params
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    say(f"{tag} {CP_ARCH} at its published widths ({widths(cfg)}), cut to "
        f"{CP_LAYERS} of its 62 layers (windows {windows}), batch 1, T = "
        f"{t} over {n} ranks of {t // n}: cache "
        f"{2 * CP_LAYERS * t * cfg.n_kv_heads * cfg.head_dim * 2 / 1e9:.2f}"
        f" GB, weights {weights / 1e9:.2f} GB")
    shape = (CP_LAYERS, 1, t, cfg.n_kv_heads, cfg.head_dim)
    k0, v0 = cp_kv(shape, gen)
    pos0 = t - CP_BACK
    rows = slice(pos0, pos0 + CP_STEPS)
    kept = (k0[:, :, rows].clone(), v0[:, :, rows].clone())
    pk, pv = k0.clone(), v0.clone()
    toks = torch.randint(0, cfg.vocab, (CP_STEPS, 1, 1), device="cuda",
                         generator=gen)
    # the whole cache without a mesh, each attention layer's input kept
    whole = {"k": k0, "v": v0, "pos": torch.tensor([pos0], device="cuda")}
    real, seen, logits = lm.decode_attention, [], []

    def spy(p, x, *args, **kw):
        seen.append(x.clone())
        return real(p, x, *args, **kw)

    with torch.no_grad(), mock.patch.object(lm, "decode_attention", spy):
        for s in range(CP_STEPS):
            logits.append(lm.decode_step(params, toks[s], whole, cfg)[0])
    k1, v1 = whole["k"], whole["v"]
    # each layer fed the whole run's input, its positions over the ranks
    threads = CpThreads(n, "data")
    errs = {"y": 0.0}
    with torch.no_grad():
        for s in range(CP_STEPS):
            pos = torch.tensor([pos0 + s], device="cuda")
            for i in range(CP_LAYERS):
                lp = lm._layer(params["layers"], i)["attn"]
                # the whole cache again: its row at pos is rewritten with
                # the same bits, from the same input
                e = cp_layer_hold(f"{tag} step {s} layer {i}", lp,
                                  seen[s * CP_LAYERS + i], (k1[i], v1[i]),
                                  (pk[i], pv[i]), pos, cfg, windows[i],
                                  threads, 1)
                errs["y"] = max(errs["y"], e["y"])
    # every written row bit-identical to the whole cache's, on its owning
    # (the last) rank only: no other position of any rank changed
    assert cp_equal(pk, k1) and cp_equal(pv, v1), \
        f"{tag}: the ranks' parts differ from the whole cache"
    # the chain through the entry point in each mode: make_serve_step on
    # the threads' (n, 1) mesh, each rank's cache Model.cache_part's of the
    # drawn cache, its positions' split installed by the step
    want = (k1[:, :, rows].clone(), v1[:, :, rows].clone())
    del whole, k0, v0, k1, v1
    gc.collect()
    torch.cuda.empty_cache()
    pk[:, :, rows], pv[:, :, rows] = kept
    drawn = {"k": pk, "v": pv, "pos": torch.tensor([pos0], device="cuda")}
    s_loc, at = t // n, pos0 - (n - 1) * (t // n)
    mine = slice(at, at + CP_STEPS)
    errs["rows"] = 0.0
    for mode in ("tp", "fsdp"):
        ranks = cp_serve(model, threads, mode, drawn, toks)
        for r, (got, toks_r, part) in enumerate(ranks):
            for s in range(CP_STEPS):
                assert torch.equal(got[s], ranks[0][0][s]), (tag, mode, r, s)
            assert torch.equal(toks_r, ranks[0][1]), (tag, mode, r)
            assert int(part["pos"][0]) == pos0 + CP_STEPS, (tag, mode, r)
        errs[f"logits_{mode}"] = max(leaf_rel(ranks[0][0][s], logits[s])
                                     for s in range(CP_STEPS))
        assert errs[f"logits_{mode}"] < CP_REL["logits"], (tag, mode, errs)
        for key, whole_leaf, rows_want in (("k", pk, want[0]),
                                           ("v", pv, want[1])):
            for r, (_, _, part) in enumerate(ranks):
                got = part[key]
                ref = whole_leaf[:, :, r * s_loc:(r + 1) * s_loc]
                if r < n - 1:          # no row of pos0.. here: untouched
                    assert cp_equal(got, ref), (tag, mode, key, r)
                    continue
                for other in (slice(0, at), slice(at + CP_STEPS, s_loc)):
                    assert cp_equal(got[:, :, other], ref[:, :, other]), \
                        (tag, mode, key)
                assert torch.equal(got[0, :, mine], rows_want[0]), \
                    (tag, mode, key)
                errs["rows"] = max(errs["rows"],
                                   leaf_rel(got[:, :, mine], rows_want))
        del ranks
        gc.collect()
        torch.cuda.empty_cache()
    assert errs["rows"] < CP_REL["rows"], (tag, errs)
    say(f"{tag} {CP_STEPS} steps at pos {pos0}..{pos0 + CP_STEPS - 1}: "
        f"each layer's y (its whole-cache input) within {errs['y']:.2e} of "
        f"the whole cache's, every rank alike, the written rows bit for bit "
        f"the whole cache's and no other position of any rank changed; the "
        f"chain through make_serve_step on the ({n}, 1) mesh of {n} ranks, "
        f"each rank's cache Model.cache_part's: logits within "
        f"{errs['logits_tp']:.2e} (\"tp\") and {errs['logits_fsdp']:.2e} "
        f"(\"fsdp\"), every rank alike, rows of layer 0 bit for bit and of "
        f"layers 1+ within {errs['rows']:.2e} on the last rank only "
        f"(bounds {CP_REL}) [{card}]")
    # times: the whole-cache step, one global layer's whole attention
    # against one rank's partial at T/n and the combine of n partials
    lp = lm._layer(params["layers"], CP_LAYERS - 1)["attn"]
    x = seen[CP_LAYERS - 1]
    with torch.no_grad():
        q, _, _ = attention._project(lp, x)
        cols = torch.arange(t, device="cuda")[None, :]
        mask = (cols <= pos0)[:, None, None, :]
        kl, vl, ml = pk[-1][:, -s_loc:], pv[-1][:, -s_loc:], \
            mask[..., -s_loc:]
        part = torch.cat(attention.decode_partial(q, kl, vl, ml), dim=-1)
        every = torch.stack([part] * n)

        def step():
            drawn["pos"].fill_(pos0)
            lm.decode_step(params, toks[0], drawn, cfg)

        times = {"step_ms": time_ms(step, 5, 1),
                 "layer_whole_ms": time_ms(lambda: attention._sdpa(
                     q, pk[-1], pv[-1], mask), 10),
                 "layer_part_ms": time_ms(lambda: attention.decode_partial(
                     q, kl, vl, ml), 10),
                 "combine_ms": time_ms(lambda: attention.combine_partials(
                     every[..., :1], every[..., 1:2], every[..., 2:]), 20)}
    say(f"{tag} times: the whole-cache decode step of {CP_LAYERS} layers "
        f"at T = {t} {times['step_ms']:.3f} ms; one global layer's "
        f"attention over T {times['layer_whole_ms']:.3f} ms, one rank's "
        f"partial at T/{n} = {t // n} {times['layer_part_ms']:.3f} ms, the "
        f"combine of {n} partials {times['combine_ms']:.4f} ms [{card}]")
    return {"errors": errs, "times": times, "layers": CP_LAYERS, "t": t,
            "ranks": n}


def cp_zamba2(card: str, gen) -> dict:
    """(b): zamba2-2.7b's shared attention block at its published widths
    (hd 80, 32 kv heads), one block at T = CP_T over CP_RANKS parts."""
    from repro_torch.configs import get_config
    from repro_torch.models.attention import init_attn_params
    tag = "[context parallel] (b)"
    cfg = get_config("zamba2-2.7b")
    n, t = CP_RANKS, CP_T
    lp = init_attn_params(torch.Generator("cuda").manual_seed(0), cfg,
                          torch.bfloat16, "cuda")
    k0, v0 = cp_kv((1, t, cfg.n_kv_heads, cfg.head_dim), gen)
    pk, pv = k0.clone(), v0.clone()
    threads = CpThreads(n, "data")
    err = 0.0
    with torch.no_grad():
        for s in range(CP_STEPS):
            pos = torch.tensor([t - CP_BACK + s], device="cuda")
            x = torch.randn((1, 1, cfg.d_model), dtype=torch.bfloat16,
                            device="cuda", generator=gen)
            err = max(err, cp_layer_hold(f"{tag} step {s}", lp, x, (k0, v0),
                                         (pk, pv), pos, cfg, 0, threads,
                                         1)["y"])
    assert cp_equal(pk, k0) and cp_equal(pv, v0), \
        f"{tag}: the ranks' parts differ from the whole cache"
    say(f"{tag} zamba2-2.7b's shared block at its published widths "
        f"(d_model {cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} "
        f"kv x {cfg.head_dim}), one block's cache of T = {t} over {n} "
        f"ranks, {CP_STEPS} steps: y within {err:.2e} of the whole cache's "
        f"(bound {CP_REL['y']}), the written rows bit for bit, no other "
        f"position changed [{card}]")
    return {"y": err}


def cp_heads(card: str, gen) -> dict:
    """(c): fsdp's kv heads over "model": deepseek-7b's CP_HEADS_LAYERS
    layers at full width, CP_HEADS_ROWS rows of CP_HEADS_T positions, each
    of the CP_RANKS ranks of "model" attending with its heads' slices of
    the layer's weights, y summed in rank order."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.attention import init_attn_params
    tag = "[context parallel] (c)"
    cfg = get_config("deepseek-7b")
    n, b, t = CP_RANKS, CP_HEADS_ROWS, CP_HEADS_T
    threads = CpThreads(n, "model")
    errs = {"y": 0.0, "rows": 0.0}
    with torch.no_grad():
        for i in range(CP_HEADS_LAYERS):
            lp = init_attn_params(torch.Generator("cuda").manual_seed(i),
                                  cfg, torch.bfloat16, "cuda")
            k0, v0 = cp_kv((b, t, cfg.n_kv_heads, cfg.head_dim), gen)
            pk, pv = k0.clone(), v0.clone()
            pos = torch.randint(t // 2, t, (b,), device="cuda",
                                generator=gen)
            x = torch.randn((b, 1, cfg.d_model), dtype=torch.bfloat16,
                            device="cuda", generator=gen)
            e = cp_layer_hold(f"{tag} layer {i}", lp, x, (k0, v0), (pk, pv),
                              pos, cfg, lm._window(cfg, i), threads, 2)
            errs["y"] = max(errs["y"], e["y"])
            at = torch.arange(b, device="cuda")
            for got, want in ((pk, k0), (pv, v0)):
                errs["rows"] = max(errs["rows"], leaf_rel(got[at, pos],
                                                          want[at, pos]))
                got[at, pos] = want[at, pos]
                assert cp_equal(got, want), f"{tag}: other rows changed"
            del k0, v0, pk, pv
    assert errs["rows"] < CP_REL["rows"], (tag, errs)
    say(f"{tag} deepseek-7b at full width, {CP_HEADS_LAYERS} layers, the "
        f"decode_32k rank's {b} rows of {t} positions, its "
        f"{cfg.n_kv_heads} kv heads over {n} ranks of \"model\" "
        f"({cfg.n_kv_heads // n} each, {cfg.n_heads // n} query heads): y "
        f"summed in rank order within {errs['y']:.2e} of the whole layer's, "
        f"the written rows within {errs['rows']:.2e} (bounds {CP_REL}) "
        f"[{card}]")
    return errs


def phase_context_parallel(card: str) -> dict:
    """Phase 13 (see CP_ARCH and the constants above): (a) gemma3-27b, (b)
    zamba2-2.7b's shared block, (c) fsdp's kv heads, (d) a batch of one on
    a (1, 1) NCCL mesh in both modes bit for bit against no mesh (the rows'
    path at one row: one rank divides the batch)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    tag = "[context parallel]"
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(31)
    out = {"gemma3": cp_gemma(card, gen)}
    gc.collect()
    torch.cuda.empty_cache()
    out["zamba2"] = cp_zamba2(card, gen)
    gc.collect()
    torch.cuda.empty_cache()
    out["heads"] = cp_heads(card, gen)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
            zero_counts()
            decoded = mesh_decode(mesh, rows=1)
            launches = read_counts()
        finally:
            dist.destroy_process_group()
    ref_tok, ref_cache = decoded.pop("none")
    for layout, (toks, cache) in decoded.items():
        assert torch.equal(toks, ref_tok), f"{tag} (d) {layout}: tokens"
        for k, v in ref_cache.items():
            assert torch.equal(cache[k], v), f"{tag} (d) {layout}: {k}"
    n = tp_config().n_layers
    say(f"{tag} (d) make_serve_step of deepseek-7b's {n} layers at full "
        f"width on the (1, 1) NCCL mesh, \"tp\" and \"fsdp\" (its kv heads "
        f"the rank's), a batch of one, which one rank of \"data\" divides, "
        f"so that nothing is split (the rows' path at one row): "
        f"{MESH_DECODE_STEPS} steps, tokens and cache bit for bit against "
        f"no mesh ({ref_tok[0].tolist()}) [{card}]")
    wall = time.perf_counter() - t0
    out.update(wall_s=wall, paths=[{"arch": TRAIN_ARCH, "n_layers": n,
                                    "path": "context parallel (d) serve",
                                    "launches": launches}])
    say(f"{tag} phase 13: {wall:.1f} s [{card}]")
    return out


# ------------------------------------------------------------- phase 14
# mamba's projections split over "model" in "tp" mode (models/ssm.py): each
# rank runs the mamba block on its own heads from the rules' slices of
# in_proj, conv_w, conv_b and out_proj (launch/collectives.exchange_columns
# hands it the columns its heads read), and the conv and ssm decode states
# lie over "model" as cache_shardings lays them, in both modes.  (b): layer
# 0 of mamba2-780m as each of MT_RANKS ranks holds it (48 heads: 24, 12 and
# 3 a rank), of zamba2-2.7b at MT_ZAMBA2_RANKS (80 heads: 5 a rank), on 1 x
# MT_TOKENS tokens
MT_RANKS, MT_ZAMBA2_RANKS, MT_TOKENS = (2, 4, 16), 16, 4096
# (b): bounds on ||the ranks' result - whole|| / ||whole|| in bf16, set
# before the first run: y and dx sum up to 16 shares, each rounded to bf16
# before the sum (as a bf16 all-reduce does), and the gradient of the B
# and C columns of in_proj and of the conv sums 16 ranks' shares; phase 9
# measured y 2.35e-3 and dx 4.01e-3 at 4 ranks (PERF.md), and 16 shares
# round about twice as often again
MT_REL = {"y": 1.5e-2, "dx": 2e-2, "grad": 3e-2}
# (a): the steps timed after the held ones, on each side
MT_TIMED_STEPS = 2
# (c): mamba2-780m at full depth on long_500k's rank (a batch of one, its
# states' channels and heads over the 16 ranks of (16, 16)'s "model"): a
# prefill of MT_PROMPT tokens, then MT_STEPS make_serve_step steps, in f32
# and in bf16.  f32 holds the split's arithmetic: the logits and each
# rank's final states within MT_F32_REL of no mesh (sums of 16 shares in
# another order, 48 layers).  bf16 holds its rounding against a
# yardstick: its distance from the f32 path without a mesh at most
# MT_BF16_YARD times that of the bf16 path without a mesh (the 16 bf16
# shares of y round some 31 times a layer where the whole layer rounds
# once, at up to a quarter of y's size: phase (b)'s y 9.84e-3 at 16 ranks
# against 2.86e-3 at 2).  An absolute bf16 bound of 3e-2 does not hold
# over 48 random bf16 layers: the bf16 path without a mesh is itself some
# 30 % from f32 there (PERF.md, findings)
MT_PROMPT, MT_STEPS, MT_DECODE_RANKS = 64, 4, 16
MT_F32_REL = 1e-4
MT_BF16_YARD = 6.0


class MambaThreads(CpThreads):
    """``CpThreads`` over the ``n`` ranks of "model", whose collectives in
    ``models/ssm.py`` and ``models/common.py`` are torch ops on the ranks'
    parts too: the gathers a concatenation, the shares of y and of the
    norm's statistic summed in rank order, "f" the identity, and the
    column exchange each rank's ranges cut from every rank's slice, so
    that one backward from the main thread runs every rank's, each
    exchange's as its reverse (the gradient of a column several ranks read
    summed into its holder); the greedy token of the vocabulary's slices
    is taken over the slices joined.  ``api.mesh_device`` takes the
    threads' mesh as the card's, so that a ``Model`` built in a rank's
    thread on it keeps that rank's slices."""

    def __init__(self, n: int):
        super().__init__(n, "model")

    def exchange_columns(self, x, mesh, axis: str, dim: int, want: tuple):
        held, parts = x.shape[dim], self.exchange(x)
        pieces = []
        for a, b in want[self.local.rank]:
            for q, part in enumerate(parts):
                lo, hi = max(a, q * held), min(b, (q + 1) * held)
                if lo < hi:
                    pieces.append(part.narrow(dim, lo - q * held, hi - lo))
        return torch.cat(pieces, dim)

    def patched(self, cache: tuple = (), mode: str = "tp", model=None):
        from unittest import mock

        from repro_torch.models import api, common, ssm
        stack = super().patched(cache, mode, model)
        same = lambda x, mesh, axis: x              # noqa: E731
        for mod, name, fn in ((ssm, "all_reduce", self.all_reduce),
                              (ssm, "copy_to", same),
                              (ssm, "gather_leaf", self.gather),
                              (ssm, "exchange_columns",
                               self.exchange_columns),
                              (common, "all_reduce", self.all_reduce),
                              (common, "copy_to", same),
                              (api, "mesh_device", lambda mesh: "cuda"),
                              (api, "vocab_argmax", self.vocab_argmax)):
            stack.enter_context(mock.patch.object(mod, name, fn))
        return stack

    def vocab_argmax(self, logits, mesh):
        return torch.argmax(torch.cat(self.exchange(logits), -1), dim=-1)


def mt_layer(cfg, leaves: dict, x, dy, nm: int | None) -> tuple:
    """``ssm.mamba_forward`` of one layer's ``leaves`` on x (1, S, D),
    forward and backward for the cotangent ``dy``: whole (``nm`` None), or
    as each of ``nm`` ranks of "model" holds it in "tp" mode
    (``shard_params`` at each coordinate; the leaves the rules replicate
    one tensor that every rank's share of the gradient reaches), the
    ranks in ``MambaThreads``.  (y, dx, {leaf: gradient}), a split leaf's
    gradient the ranks' slices joined along its split dim; every rank's y
    must be alike."""
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.shardings import (model_dim, param_spec,
                                              shard_params)
    from repro_torch.models import ssm
    lv = {k: v.detach().clone().requires_grad_() for k, v in leaves.items()}
    xx = x.detach().clone().requires_grad_()
    if nm is None:
        y = ssm.mamba_forward(lv, xx, cfg)[0]
        y.backward(dy)
        return y.detach(), xx.grad, {k: v.grad for k, v in lv.items()}
    spec = MeshSpec(("data", "model"), (1, nm))
    parts = []
    for r in range(nm):
        part = shard_params(lv, spec, "tp", {"data": 0, "model": r})
        parts.append({k: v if v is lv[k] else v.detach().requires_grad_()
                      for k, v in part.items()})
    threads = MambaThreads(nm)
    with threads.patched(mode="tp"):
        ys = threads.run(lambda r: ssm.mamba_forward(parts[r], xx, cfg)[0])
    assert all(torch.equal(y, ys[0]) for y in ys), "the ranks' y differ"
    ys[0].backward(dy)
    grads = {}
    for k, v in lv.items():
        d = model_dim(param_spec(k, v.shape, spec))
        grads[k] = v.grad if d is None else torch.cat(
            [p[k].grad for p in parts], dim=d)
    return ys[0].detach(), xx.grad, grads


def mt_rank_parts(card: str) -> dict:
    """(b): layer 0 of mamba2-780m whole and at each of MT_RANKS ranks, of
    zamba2-2.7b at MT_ZAMBA2_RANKS, bf16 at published widths (seed 0), on
    1 x MT_TOKENS tokens: the ranks' y (summed in rank order), dx and every
    leaf's gradient held to the whole layer's within MT_REL; the SSD
    kernels launched at each rank's heads."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    heads: list = []
    real = ssm.ssd_intra_chunk

    def spy(xc, *args):
        heads.append(xc.shape[3])
        return real(xc, *args)

    out, launches = {}, {}
    zero_counts()
    for arch, counts in ((MAMBA2, MT_RANKS), (ZAMBA2, (MT_ZAMBA2_RANKS,))):
        cfg = get_config(arch).replace(remat="none")
        gen = torch.Generator("cuda").manual_seed(0)
        leaves = ssm.init_mamba_params(gen, cfg, torch.bfloat16, "cuda")
        gen = torch.Generator("cuda").manual_seed(25)
        x, dy = (torch.randn((1, MT_TOKENS, cfg.d_model), generator=gen,
                             device="cuda").to(torch.bfloat16)
                 for _ in range(2))
        y, dx, grads = mt_layer(cfg, leaves, x, dy, None)
        for nm in counts:
            heads.clear()
            with mock.patch.object(ssm, "ssd_intra_chunk", spy):
                yr, dxr, gr = mt_layer(cfg, leaves, x, dy, nm)
            assert heads == [cfg.ssm_heads // nm] * nm, (arch, nm, heads)
            worst = {k: leaf_rel(gr[k], grads[k]) for k in grads}
            errs = {"y": leaf_rel(yr, y), "dx": leaf_rel(dxr, dx),
                    "grad": max(worst.values()),
                    "worst_leaf": max(worst, key=worst.get),
                    "heads": cfg.ssm_heads // nm}
            for k in ("y", "dx", "grad"):
                assert errs[k] <= MT_REL[k], \
                    f"[mamba tp] (b) {arch} at {nm} ranks: {errs} > {MT_REL}"
            out[f"{arch} nm{nm}"] = errs
            del yr, dxr, gr
        del leaves, x, dy, y, dx, grads
        gc.collect()
        torch.cuda.empty_cache()
    launches = read_counts()
    n_parts = 2 + sum(MT_RANKS) + MT_ZAMBA2_RANKS
    assert launches["ssd_intra_chunk"] == n_parts and \
        launches["ssd_intra_chunk_bwd"] == n_parts, launches
    return {"errors": out, "launches": launches}


def mt_ssd_ms(gen) -> dict:
    """The SSD forward and its backward at the heads of mamba2-780m's and
    zamba2-2.7b's ranks ((b)'s), on 1 x MT_TOKENS tokens: the forward's
    time as issued (CUDA events over 20 calls) and replayed from a CUDA
    graph, the forward and backward's on the device alone."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import ssd_intra_chunk
    out = {}
    for arch, counts in ((MAMBA2, (1, *MT_RANKS)),
                         (ZAMBA2, (1, MT_ZAMBA2_RANKS))):
        cfg = get_config(arch)
        nc, l = MT_TOKENS // cfg.ssm_chunk, cfg.ssm_chunk
        for nm in counts:
            h = cfg.ssm_heads // nm
            xc, dtc, cum, bc, cc = ssd_inputs(1, nc, l, h, cfg.ssm_head_dim,
                                              cfg.ssm_state, True, gen)
            ins = [t.detach().requires_grad_()
                   for t in (xc, dtc, cum, bc, cc)]
            dy, ds = ssd_cotangents((1, nc, l, h, cfg.ssm_head_dim,
                                     cfg.ssm_state), "both", gen)

            def fwd(xc=xc, dtc=dtc, cum=cum, bc=bc, cc=cc):
                return ssd_intra_chunk(xc, dtc, cum, bc, cc)

            def fwd_bwd(ins=ins, dy=dy, ds=ds):
                y, st = ssd_intra_chunk(*ins)
                torch.autograd.grad((y, st), ins, (dy, ds))

            out[f"{arch.split('-')[0]} {h} heads"] = {
                "shape": [1, nc, l, h, cfg.ssm_head_dim, cfg.ssm_state],
                "fwd_ms": time_ms(fwd, 20), "fwd_graph_ms": graph_ms(fwd),
                "fwd_bwd_device_ms": device_ms(fwd_bwd)}
    return out


def mt_decode_ms(card: str) -> dict:
    """One mamba2-780m layer's decode of a batch of one (bf16, seed 0), as
    issued (CUDA events over 50 calls) and replayed from a CUDA graph:
    the whole layer; the last of MT_DECODE_RANKS ranks' share (its slices,
    its parts of the states), the collectives as local stand-ins that write
    what they would (a gather the n parts' bytes, a sum a copy: the one
    card has no other rank); and those stand-ins alone."""
    from contextlib import ExitStack
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.shardings import shard_params
    from repro_torch.models import common, ssm
    cfg = get_config(MAMBA2)
    n, r = MT_DECODE_RANKS, MT_DECODE_RANKS - 1
    gen = torch.Generator("cuda").manual_seed(0)
    leaves = ssm.init_mamba_params(gen, cfg, torch.bfloat16, "cuda")
    c = cfg.d_inner + 2 * cfg.ssm_state
    gen = torch.Generator("cuda").manual_seed(26)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)
    x1 = draw(1, 1, cfg.d_model)
    conv, st = draw(1, cfg.ssm_conv - 1, c), draw(
        1, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    spec = MeshSpec(("data", "model"), (1, n))
    part = shard_params(leaves, spec, "tp", {"data": 0, "model": r})
    cl, hl = c // n, cfg.ssm_heads // n
    conv_p = conv[..., r * cl:(r + 1) * cl].contiguous()
    st_p = st[:, r * hl:(r + 1) * hl].contiguous()

    def gather(x, mesh, dim: int, axes="model"):
        return torch.cat([x] * n, dim)

    def total(x, mesh, axes, grad_scale: float = 1.0):
        return x.clone()

    def same(x, mesh, axis):
        return x

    res = {}
    with torch.no_grad():
        whole = lambda: ssm.mamba_decode(leaves, x1, conv, st, cfg)  # noqa
        res["whole_ms"] = time_ms(whole, 50)
        res["whole_graph_ms"] = graph_ms(whole)
        with ExitStack() as stack:
            for mod, name, fn in (
                    (ssm, "gather_leaf", gather), (ssm, "all_reduce", total),
                    (ssm, "copy_to", same), (common, "all_reduce", total),
                    (common, "copy_to", same),
                    (common, "seq_rank", lambda mesh, axes, coord=None:
                     (r, n) if axes else (0, 1))):
                stack.enter_context(mock.patch.object(mod, name, fn))
            stack.enter_context(common.use_mesh(spec, "tp", rows=()))
            share = lambda: ssm.mamba_decode(part, x1, conv_p, st_p,  # noqa
                                             cfg)
            res["share_ms"] = time_ms(share, 50)
            res["share_graph_ms"] = graph_ms(share)
        w = (2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads) // n
        row, cv = draw(1, 1, w), draw(1, cl)
        ss = torch.zeros((1, 1, 1), device="cuda")
        y = draw(1, 1, cfg.d_model)

        def exchanges():
            gather(row, None, 2)
            gather(cv, None, 1)
            total(ss, None, "model")
            total(y, None, "model")
        res["exchanges_ms"] = time_ms(exchanges, 50)
        res["exchanges_graph_ms"] = graph_ms(exchanges)
    return res


def mt_chain(models: list, threads: MambaThreads, mode: str, cache: dict,
             toks: list) -> list:
    """``make_serve_step(models[r])`` on the threads' (1, n) mesh in
    ``mode``, each rank in its thread: its cache ``Model.cache_part``'s of
    the whole ``cache`` (its own ``pos``), ``toks[s]`` fed at step s.  Per
    rank: (each step's logits, the final part)."""
    from unittest import mock

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import lm
    real, logits = lm.decode_step, [[] for _ in range(threads.n)]

    def spy(*args, **kw):
        out = real(*args, **kw)
        logits[threads.local.rank].append(out[0].clone())
        return out

    def rank(r):
        part = models[r].cache_part(cache)
        part["pos"] = part["pos"].clone()
        step = make_serve_step(models[r])
        for tok in toks:
            _, part = step(tok, part)
        return part

    with torch.no_grad(), threads.patched(
            mode=mode, model=models[0] if mode == "fsdp" else None), \
            mock.patch.object(lm, "decode_step", spy):
        parts = threads.run(rank)
    return [(logits[r], parts[r]) for r in range(threads.n)]


def mt_whole(cfg, state: dict | None, prompt, feed: list | None = None
             ) -> tuple:
    """mamba2-780m of ``cfg`` without a mesh (seed 0, or ``state``): a
    prefill of ``prompt``, then MT_STEPS decode steps, fed the greedy
    tokens or ``feed``'s.  (the model, the prefill's cache, the tokens fed
    at each step, each step's logits, the final cache, the prefill's
    launches)."""
    from repro_torch.models import Model
    whole = Model(cfg, device="cuda")
    if state is None:
        whole.init(torch.Generator("cuda").manual_seed(0))
    else:
        whole.load_state(state)
    zero_counts()
    with torch.no_grad():
        logits, cache0 = whole.prefill({"tokens": prompt})
        launches = read_counts()
        toks, want = [whole.greedy(logits)[:, None]], []
        cache = {k: v.clone() for k, v in cache0.items()}
        for s in range(MT_STEPS):
            tok = toks[-1] if feed is None else feed[s]
            lg, cache = whole.decode_step(tok, cache)
            want.append(lg)
            toks.append(whole.greedy(lg)[:, None])
    return whole, cache0, feed or toks[:-1], want, cache, launches


def mt_errors(got: list, want: list, cache: dict) -> dict:
    """The worst leaf_rel over the steps of the ranks' logits (every rank
    alike, or the ranks' vocabulary slices joined) against ``want``, and
    over the ranks of each rank's final conv and ssm part against its
    slice of ``cache``."""
    n = len(got)
    e = {"logits": 0.0, "conv": 0.0, "ssm": 0.0}
    for s in range(MT_STEPS):
        lgs = [g[0][s] for g in got]
        if lgs[0].shape[-1] != want[s].shape[-1]:    # vocab slices
            lgs = [torch.cat(lgs, -1)]
        assert all(torch.equal(lg, lgs[0]) for lg in lgs), s
        e["logits"] = max(e["logits"], leaf_rel(lgs[0], want[s]))
    for r, (_, part) in enumerate(got):
        for key, dim in (("conv", -1), ("ssm", -3)):
            size = cache[key].shape[dim] // n
            assert part[key].shape[dim] == size, key
            e[key] = max(e[key], leaf_rel(
                part[key], cache[key].narrow(dim, r * size, size)))
    return e


def mt_decode(card: str) -> dict:
    """(c): mamba2-780m at full depth (seed 0; its f32 twin the same bf16
    values in f32): a prefill of a batch of one without a mesh, MT_STEPS
    steps of greedy decode without a mesh, then the same steps, fed the
    same tokens, on MT_DECODE_RANKS ranks of "model" as threads, in "tp"
    (each rank's ``Model`` holding its slices) and "fsdp" (whole leaves,
    of which each rank cuts its own), each rank's cache
    ``Model.cache_part``'s, every path fed the bf16 path's tokens.  In f32
    the logits (every rank alike, or the
    ranks' vocabulary slices joined) and each rank's final conv and ssm
    parts within MT_F32_REL of no mesh's; in bf16 their distance from the
    f32 path without a mesh within MT_BF16_YARD times the bf16 path's
    without a mesh."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.common import set_sharding_mode
    n = MT_DECODE_RANKS
    cfg16 = get_config(MAMBA2)
    cfg32 = cfg16.replace(param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator("cuda").manual_seed(27)
    prompt = torch.randint(0, cfg16.vocab, (1, MT_PROMPT), device="cuda",
                           generator=gen)
    whole16, cache16, toks16, want16, end16, launches = mt_whole(
        cfg16, None, prompt)
    state16 = whole16.state_dict()
    whole32, cache32, toks32, want32, end32, more = mt_whole(
        cfg32, {k: v.float() for k, v in state16.items()}, prompt, toks16)
    launches = {k: v + more[k] for k, v in launches.items()}
    threads = MambaThreads(n)
    set_sharding_mode("tp")
    out = {}
    for dt, cfg, whole, cache0, toks, want, end in (
            ("f32", cfg32, whole32, cache32, toks32, want32, end32),
            ("bf16", cfg16, whole16, cache16, toks16, want16, end16)):
        state = whole.state_dict()
        with threads.patched(mode="tp"):
            models = threads.run(lambda r, cfg=cfg, state=state: Model(
                cfg, device="cuda", mesh=threads.mesh).load_state(state))
        for mode, ms in (("tp", models), ("fsdp", [whole] * n)):
            got = mt_chain(ms, threads, mode, cache0, toks)
            if dt == "f32":
                e = mt_errors(got, want, end)
                bad = {k: v for k, v in e.items() if v > MT_F32_REL}
            else:    # against the f32 path, beside the bf16 path's own
                e = mt_errors(got, want32, end32)
                yard = mt_errors([(want16, {k: end16[k].narrow(
                    d, r * (end16[k].shape[d] // n),
                    end16[k].shape[d] // n) for k, d in (("conv", -1),
                                                         ("ssm", -3))})
                                  for r in range(n)], want32, end32)
                e.update({f"{k}_yardstick": v for k, v in yard.items()})
                bad = {k: e[k] for k in yard
                       if e[k] > MT_BF16_YARD * max(yard[k], MT_F32_REL)}
            assert not bad, f"[mamba tp] (c) {dt} {mode}: {e}"
            out[f"{dt} {mode}"] = e
        del models
        gc.collect()
        torch.cuda.empty_cache()
    return {"errors": out, "launches": launches,
            "rank_conv": [*end16["conv"].shape[:-1],
                          end16["conv"].shape[-1] // n],
            "rank_ssm": [*end16["ssm"].shape[:2], end16["ssm"].shape[2] // n,
                         *end16["ssm"].shape[3:]]}


def phase_mamba_tp(card: str, served: list | None) -> dict:
    """Phase 14 (see MT_* above).  ``served``: phase 5's greedy tokens of
    mamba2-780m without a mesh, which the mesh's engine must repeat (None
    with ``--mamba-tp-only``: this phase's own engine without a mesh)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    tag = "[mamba tp]"
    t0 = time.perf_counter()
    cfg = get_config(MAMBA2)
    n = cfg.n_layers
    state = Model(cfg, device="cuda").init(
        torch.Generator("cuda").manual_seed(0)).state_dict()
    gen = torch.Generator("cuda").manual_seed(24)
    toks = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ + 1),
                         device="cuda", generator=gen)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    walls, mark = {}, time.perf_counter()

    def lap(key: str) -> None:
        nonlocal mark
        now = time.perf_counter()
        walls[key] = now - mark
        mark = now

    one = tp_serve(cfg, None, card) if served is None else None
    lap("serve without a mesh")
    ref = tp_steps(cfg, None, state, batch, timed=MT_TIMED_STEPS)
    ref.pop("model"), ref.pop("state")
    zero = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "moe_gmm": 0,
            "moe_gmm_bwd": 0}
    want = {**zero, "ssd_intra_chunk": 2 * n * TP_STEPS,
            "ssd_intra_chunk_bwd": n * TP_STEPS}
    assert ref["launches"] == want, (ref["launches"], want)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
            tp = tp_steps(cfg, mesh, state, batch, ref=ref, card=card,
                          timed=MT_TIMED_STEPS)
            sliced = sorted(k for k in tp["model"].sharded
                            if k.split(".")[-1] in ("in_proj", "conv_w",
                                                    "conv_b", "out_proj"))
            tp.pop("model"), tp.pop("state")
            lap("(a) training")
            serve = tp_serve(cfg, mesh, card)
            lap("(a) serving")
        finally:
            dist.destroy_process_group()
    del state, ref["grads"]
    assert len(sliced) == 4, sliced
    assert tp["launches"] == want, (tp["launches"], want)
    bad = {k: v for k, v in tp["grads"].items() if v != 0.0}
    assert not bad, f"{tag} step-1 gradients not bit-identical: {bad}"
    assert tp["losses"] == ref["losses"] and \
        tp["grad_norms"] == ref["grad_norms"], (tp, ref)
    want_serve = {**zero, "ssd_intra_chunk": n * SERVE_REQUESTS,
                  "ssd_intra_chunk_bwd": 0}
    assert serve["launches"] == want_serve, serve["launches"]
    served = one["tokens"] if served is None else served
    assert serve["tokens"] == served, f"{tag} served tokens differ"
    say(f"{tag} (a) mamba2-780m at full width and depth ({n} layers, "
        f"{widths(cfg)}), bf16, remat {cfg.remat}, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, {TP_STEPS} make_train_step steps (AdamW, bf16 "
        f"moments) from one state: world 1 on NCCL, a (1, 1) mesh in \"tp\""
        f" mode, the mamba block on its split path ({', '.join(sliced)} "
        f"sliced, whole at one rank; the column exchanges, the norm's "
        f"summed statistic and \"g\" on NCCL), bit-identical to the steps "
        f"without a mesh in every step-1 gradient leaf, the losses "
        + ", ".join(f"{v:.6f}" for v in tp["losses"]) + " and the grad "
        "norms " + ", ".join(f"{v:.6f}" for v in tp["grad_norms"])
        + f"; launches {tp['launches']} [{card}]")
    for key, res in (("without a mesh", ref), ("tp (1, 1)", tp)):
        prof = res.get("profile")
        say(f"{tag} (a) {key}: {res['ms_per_step']:.2f} ms/step (median of "
            f"steps {TP_STEPS + 1}-{TP_STEPS + MT_TIMED_STEPS}; steps "
            + ", ".join(f"{t:.1f}" for t in res["step_ms"]) + " ms)"
            + ("" if prof is None else
               f"; profiled step: NCCL kernels "
               f"{prof.get('groups', {}).get('nccl', 0.0):.3f} ms, device "
               f"busy {prof.get('device_busy_ms', 0.0):.2f} ms")
            + f" [{card}]")
    say(f"{tag} (a) served {SERVE_REQUESTS} requests on the (1, 1) mesh: "
        f"greedy tokens equal to " + ("this phase's engine without a mesh"
                                      if one else "phase 5's")
        + f"; decode {serve['decode_ms_per_step']:.2f} ms/step, prefill "
        f"{serve['prefill_ms_per_request']:.2f} ms/request; launches "
        f"{serve['launches']} [{card}]")
    parts = mt_rank_parts(card)
    lap("(b)")
    for key, errs in parts["errors"].items():
        say(f"{tag} (b) {key}: layer 0 at published widths, bf16, 1 x "
            f"{MT_TOKENS} tokens, the SSD kernels at {errs['heads']} heads a "
            f"rank: ||ranks - whole|| / ||whole|| y {errs['y']:.3e}, dx "
            f"{errs['dx']:.3e}, worst gradient {errs['grad']:.3e} "
            f"({errs['worst_leaf']}) (bounds {MT_REL}) [{card}]")
    decode = mt_decode(card)
    lap("(c)")
    for key, e in decode["errors"].items():
        dt, mode = key.split()
        against = "no mesh's" if dt == "f32" else (
            "the f32 path's without a mesh (the bf16 path without a mesh: "
            f"logits {e['logits_yardstick']:.3e}, conv "
            f"{e['conv_yardstick']:.3e}, ssm {e['ssm_yardstick']:.3e}; "
            f"bound {MT_BF16_YARD} times those)")
        say(f"{tag} (c) mamba2-780m at all {n} layers in {dt}, a batch of "
            f"one after a {MT_PROMPT}-token prefill, {MT_STEPS} "
            f"make_serve_step steps on {MT_DECODE_RANKS} ranks of \"model\" "
            f"in \"{mode}\", each rank's states Model.cache_part's (conv "
            f"{decode['rank_conv']}, ssm {decode['rank_ssm']}): logits "
            f"every rank alike; logits {e['logits']:.3e}, final conv parts "
            f"{e['conv']:.3e}, ssm parts {e['ssm']:.3e} from {against}"
            + (f" (bound {MT_F32_REL})" if dt == "f32" else "")
            + f" [{card}]")
    gen = torch.Generator("cuda").manual_seed(28)
    ssd = mt_ssd_ms(gen)
    say(f"{tag} SSD on 1 x {MT_TOKENS} tokens (chunk 256) by heads a rank: "
        + "; ".join(f"{k}: fwd {t['fwd_ms']:.4f} ms as issued, "
                    f"{t['fwd_graph_ms']:.4f} on the device; fwd + bwd "
                    f"{t['fwd_bwd_device_ms']:.4f} on the device"
                    for k, t in ssd.items()) + f" [{card_line()}]")
    dec = mt_decode_ms(card)
    lap("timing")
    say(f"{tag} one mamba2-780m layer's decode, batch 1: whole "
        f"{dec['whole_ms']:.4f} ms as issued, {dec['whole_graph_ms']:.4f} "
        f"on the device; rank {MT_DECODE_RANKS - 1} of {MT_DECODE_RANKS}'s "
        f"share {dec['share_ms']:.4f} / {dec['share_graph_ms']:.4f} (its "
        f"collectives as local stand-ins); those stand-ins alone "
        f"{dec['exchanges_ms']:.4f} / {dec['exchanges_graph_ms']:.4f} "
        f"[{card_line()}]")
    wall = time.perf_counter() - t0
    say(f"{tag} phase 14: {wall:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items()) + f") [{card_line()}]")
    paths = [{"arch": MAMBA2, "n_layers": n, "path": "mamba tp world 1 "
              "train", "launches": tp["launches"]},
             {"arch": MAMBA2, "n_layers": n, "path": "mamba tp world 1 "
              "serve", "launches": serve["launches"]},
             {"arch": MAMBA2, "n_layers": 1, "path": "mamba tp ranks' "
              "layers", "launches": parts["launches"]},
             {"arch": MAMBA2, "n_layers": n, "path": "mamba tp decode's "
              "prefill", "launches": decode["launches"]}]
    for res in (ref, tp):
        res.pop("grads", None)
    if one is not None:
        one.pop("tokens")
    serve.pop("tokens")
    return {"card": card, "reference": ref, "tp": tp, "serve": serve,
            "serve_reference": one, "rank_parts": parts,
            "decode": decode, "ssd_ms": ssd, "decode_ms": dec,
            "wall_s": wall, "wall_s_by_part": walls, "paths": paths}


# ------------------------------------------------------------- phase 15
# WOW's scheduler core on the card.  (a) benchmarks/scheduler_scale.py's
# batched-drain scenario (`_bd_build` / `_bd_wave`, lines 632-690) at its
# larger size: 1024 nodes of 128 GiB and 16 cores, 4096 ready fan-in tasks
# of 48 GiB and 6 cores, each with two 1-4 GiB inputs on disjoint random
# hosts replicated three ways, then WOW_WAVES waves; flat and on the
# benchmark's `site` topology.  (b) the mock RM driving make_adapter("wow")
# through a seeded fan-in DAG over WOW_RM_NODES nodes, on the virtual clock
# so that the event order is the seed's alone.
WOW_DRAIN = (1024, 4096)
WOW_WAVES = 3
WOW_TOPOS = {"flat": None,
             "site": {"rack_size": 32, "racks_per_site": 4,
                      "oversubscription": 8.0}}
WOW_RM_NODES, WOW_RM_WIDTH, WOW_RM_STAGES, WOW_RM_FANIN = 64, 48, 4, 4
WOW_RM_CFG = dict(decline_prob=0.3, external_load=0.3, seed=0)
GIB = 1024 ** 3


def wow_drain(device: str, n_nodes: int, n_ready: int, topo) -> dict:
    """The drain scenario on ``device``: every schedule() round's actions
    as tuples, the host ms of each round (the card synchronized after it),
    the scheduler's phase seconds and its drain counters."""
    import random

    from repro_torch.bridge import actions_to_plain
    from repro_torch.core import (DataPlacementService, FileSpec, NodeState,
                                  TaskSpec, WowScheduler)
    from repro_torch.sim import Topology, TopologySpec
    rng = random.Random(0)
    nodes = {i: NodeState(i, 128 * GIB, 16.0) for i in range(n_nodes)}
    dps = DataPlacementService(seed=0)
    if topo is not None:
        dps.set_topology(Topology(TopologySpec(**topo), n_nodes, 100.0))
    sched = WowScheduler(nodes, dps, device=device)
    state = {"fid": 10 ** 6}

    def submit(tid: int) -> None:
        for _ in range(2):
            hosts = rng.sample(range(n_nodes), 3)
            dps.register_file(FileSpec(id=state["fid"],
                                       size=rng.randint(1, 4) * GIB,
                                       producer=-1), hosts[0])
            for h in hosts[1:]:
                dps.add_replica(state["fid"], h)
            state["fid"] += 1
        sched.submit(TaskSpec(id=tid, abstract="a", mem=48 * GIB, cores=6.0,
                              inputs=(state["fid"] - 2, state["fid"] - 1),
                              priority=rng.uniform(1, 10)))

    t0 = time.perf_counter()
    for t in range(n_ready):
        submit(t)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t0
    rounds, round_ms = [], []

    def timed_round() -> None:
        t = time.perf_counter()
        acts = sched.schedule()
        sync()
        round_ms.append(1e3 * (time.perf_counter() - t))
        rounds.append(actions_to_plain(acts))

    timed_round()
    next_id = n_ready
    for _ in range(WOW_WAVES):
        finished = list(sched.running.items())
        for tid, node in finished:
            sched.on_task_finished(tid, node)
        for cid in list(sched.active_cops):
            sched.on_cop_finished(sched.active_cops[cid], ok=True)
        for _ in range(len(finished)):
            submit(next_id)
            next_id += 1
        timed_round()
    on = {sched._cap_array.free_mem.device.type,
          dps.matrix.pbytes.device.type}
    assert on == {device}, f"[wow] the drain's tensors lie on {on}"
    return {"rounds": rounds, "round_ms": round_ms, "setup_s": setup_s,
            "phase_s": dict(sched.phase_s),
            "drain_stats": dict(sched.drain_stats),
            "cops": sched.cops_created, "tasks": sched.tasks_started}


def wow_dag(seed: int = 0):
    """A seeded fan-in DAG: WOW_RM_STAGES stages of WOW_RM_WIDTH tasks, each
    task past the first stage reading WOW_RM_FANIN random outputs of the
    stage before; sizes, shapes and priorities drawn from ``seed``."""
    import random

    from repro_torch.core import FileSpec, TaskSpec
    rng = random.Random(seed)
    tasks, files, prev = {}, {}, []
    tid = 0
    for s in range(WOW_RM_STAGES):
        new = []
        for w in range(WOW_RM_WIDTH):
            files[tid] = FileSpec(id=tid, size=rng.randint(64, 1024) << 20,
                                  producer=tid)
            inputs = tuple(rng.sample(prev, WOW_RM_FANIN)) if prev else ()
            tasks[tid] = TaskSpec(id=tid, abstract=f"s{s}",
                                  mem=rng.randint(2, 16) * GIB,
                                  cores=float(rng.randint(1, 8)),
                                  inputs=inputs, outputs=(tid,),
                                  priority=float(WOW_RM_STAGES - s)
                                  + rng.random())
            new.append(tid)
            tid += 1
        prev = new
    return tasks, files


def wow_mock_rm(device: str) -> dict:
    """(b): the mock RM through make_adapter("wow", ...) on ``device``; each
    schedule() call is logged and timed on the host clock, the card
    synchronized before the clock is read."""
    import dataclasses

    from repro_torch.bridge import actions_to_plain
    from repro_torch.core import NodeState, make_adapter
    from repro_torch.runtime import MockResourceManager, MockRMConfig
    from repro_torch.runtime.mockrm import run_on_virtual_clock
    nodes = {i: NodeState(i, 64 * GIB, 16.0) for i in range(WOW_RM_NODES)}
    ad = make_adapter("wow", nodes, seed=0, device=device)
    tasks, files = wow_dag()
    calls, actions = [], []
    inner = ad.schedule
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def timed():
        t = time.perf_counter()
        acts = inner()
        sync()
        calls.append(time.perf_counter() - t)
        actions.extend(acts)
        return acts
    ad.schedule = timed
    rm = MockResourceManager(ad, tasks, files, MockRMConfig(**WOW_RM_CFG))
    t0 = time.perf_counter()
    report = run_on_virtual_clock(rm.run())
    wall = time.perf_counter() - t0
    assert report.completed == len(tasks) and report.declines > 0, report
    return {"report": dataclasses.asdict(report),
            "actions": actions_to_plain(actions), "wall_s": wall,
            "schedule_calls": len(calls),
            "ms_per_schedule": 1e3 * sum(calls) / max(len(calls), 1),
            "drain_stats": dict(ad.sched.drain_stats)}


def phase_wow(card: str) -> dict:
    """Phase 15: WOW's scheduler core at ``device="cuda"`` held against
    itself at ``device="cpu"``, decision for decision (see WOW_* above)."""
    tag = "[wow]"
    t0 = time.perf_counter()
    n_nodes, n_ready = WOW_DRAIN
    drains = {}
    for topo, spec in WOW_TOPOS.items():
        runs = {dev: wow_drain(dev, n_nodes, n_ready, spec)
                for dev in ("cuda", "cpu")}
        gpu, cpu = runs["cuda"], runs["cpu"]
        for i, (a, b) in enumerate(zip(gpu["rounds"], cpu["rounds"])):
            assert a == b, f"{tag} (a) {topo} round {i}: the card's " \
                f"{len(a)} actions differ from the CPU's {len(b)}"
        assert len(gpu["rounds"]) == len(cpu["rounds"]) == WOW_WAVES + 1
        assert gpu["drain_stats"] == cpu["drain_stats"]
        assert gpu["drain_stats"]["step2_kernel"] > 0
        n_act = [len(r) for r in gpu["rounds"]]
        for dev, r in runs.items():
            say(f"{tag} (a) {topo} {n_nodes} nodes x {n_ready} tasks on "
                f"{dev}: ms per schedule() "
                + ", ".join(f"{x:.1f}" for x in r["round_ms"])
                + f" (mean {sum(r['round_ms']) / len(r['round_ms']):.1f}); "
                f"step1 {r['phase_s']['step1_s']:.3f} s, steps 2-3 "
                f"{r['phase_s']['step23_s']:.3f} s; set-up {r['setup_s']:.2f}"
                f" s [{card}]")
        say(f"{tag} (a) {topo}: every round's actions equal on cuda and cpu "
            f"({n_act} actions, {gpu['cops']} COPs, {gpu['tasks']} starts; "
            f"drain {gpu['drain_stats']})")
        for r in runs.values():
            r.pop("rounds")
        drains[topo] = {"actions_per_round": n_act, **runs}
    t_a = time.perf_counter() - t0
    rms = {dev: wow_mock_rm(dev) for dev in ("cuda", "cpu")}
    assert rms["cuda"]["report"] == rms["cpu"]["report"], rms
    assert rms["cuda"]["actions"] == rms["cpu"]["actions"], \
        f"{tag} (b) the mock RM's action streams differ"
    assert rms["cuda"]["drain_stats"] == rms["cpu"]["drain_stats"]
    rep = rms["cuda"]["report"]
    for dev, r in rms.items():
        say(f"{tag} (b) mock RM, {WOW_RM_NODES} nodes, "
            f"{WOW_RM_STAGES}x{WOW_RM_WIDTH} fan-in DAG on {dev}: "
            f"{r['wall_s']:.2f} s wall, {r['schedule_calls']} schedule() "
            f"calls, {r['ms_per_schedule']:.2f} ms each [{card}]")
    say(f"{tag} (b) report and {len(rms['cuda']['actions'])} actions equal "
        f"on cuda and cpu: {rep}")
    for r in rms.values():
        r.pop("actions")
    wall = time.perf_counter() - t0
    say(f"{tag} phase 15: {wall:.1f} s ((a) {t_a:.1f}, (b) "
        f"{wall - t_a:.1f}) [{card}]")
    return {"card": card, "drain": drains, "drain_size": list(WOW_DRAIN),
            "waves": WOW_WAVES, "mock_rm": rms, "wall_s": wall}


# ------------------------------------------------------------- phase 16
# WOW's simulator on the card.  (a) the paper's evaluation: every registry
# workflow under wow on SimConfig()'s cluster, at benchmarks/common.py's
# SIM_SCALES (copied: benchmarks/ imports the JAX package), the ML
# pipelines at 1.0; (b) benchmarks/scheduler_scale.py's sim_throughput
# case (SIM_SIZES, line 286) at 1024 nodes, flat and on its `site`
# topology (TOPO_CONFIGS, line 800); (c) churn and open-loop traffic.
SIM_SCALES = {
    "rnaseq": 0.1, "sarek": 0.06, "chipseq": 0.08, "rangeland": 0.04,
    "syn_blast": 0.5, "syn_bwa": 0.5, "syn_cycles": 0.5, "syn_genome": 0.5,
    "syn_montage": 0.5, "syn_seismology": 0.5, "syn_soykb": 0.5,
    "all_in_one": 1.0, "chain": 1.0, "fork": 1.0, "group": 1.0,
    "group_multiple": 1.0,
}
SIM_SIZE = (1024, 10.24)
SIM_SITE = {"rack_size": 32, "racks_per_site": 4, "oversubscription": 8.0,
            "core_oversubscription": 2.0}
SIM_CHURN = {"scale": 0.25, "fail": (30.0, 1), "join": (45.0, 8)}


def sim_once(device: str, workflow: str, scale: float, strategy: str,
             cfg: dict | None = None, churn: dict | None = None,
             traffic=None) -> dict:
    """One simulation on ``device``: its result as a dict, its action log,
    the wall seconds (the card synchronized before the clock is read) and
    the flow network's dense fills."""
    import dataclasses

    from repro_torch.sim import SimConfig, Simulation, TopologySpec
    from repro_torch.workloads import make_workflow
    cfg = dict(cfg or {})
    if cfg.get("topology") is not None:
        cfg["topology"] = TopologySpec(**cfg["topology"])
    wf = None if traffic is not None else make_workflow(workflow, scale=scale)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    sim = Simulation(wf, SimConfig(**cfg), strategy, traffic=traffic,
                     device=device)
    if churn:
        sim.schedule_failure(*churn["fail"])
        sim.schedule_join(*churn["join"])
    res = sim.run()
    sync()
    wall = time.perf_counter() - t0
    out = {"result": dataclasses.asdict(res), "log": sim.action_log,
           "wall_s": wall, "steps": res.sim_steps,
           "dense_fills": getattr(sim.fm, "dense_fills", 0)}
    if traffic is not None:
        out["traffic"] = dataclasses.asdict(sim.traffic_result())
    return out


def sim_pair(tag: str, *args, **kw) -> dict:
    """``sim_once`` on the card and on the CPU; results and logs must be
    equal.  Returns the card's record with the CPU's wall time beside it."""
    runs = {dev: sim_once(dev, *args, **kw) for dev in ("cuda", "cpu")}
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert gpu["result"] == cpu["result"], \
        f"[sim] {tag}: the card's SimResult differs from the CPU's"
    assert gpu["log"] == cpu["log"], \
        f"[sim] {tag}: the card's {len(gpu['log'])} actions differ from " \
        f"the CPU's {len(cpu['log'])}"
    assert gpu.get("traffic") == cpu.get("traffic"), \
        f"[sim] {tag}: the card's TrafficResult differs from the CPU's"
    assert gpu["dense_fills"] == cpu["dense_fills"]
    rec = {k: gpu[k] for k in ("steps", "dense_fills")}
    rec.update(makespan=gpu["result"]["makespan"], actions=len(gpu["log"]),
               wall_s={dev: r["wall_s"] for dev, r in runs.items()},
               events_per_s={dev: r["steps"] / r["wall_s"]
                             for dev, r in runs.items()})
    if "traffic" in gpu:
        rec["traffic"] = {k: gpu["traffic"][k] for k in (
            "arrivals", "admitted", "rejected", "completed", "retries",
            "latency_p50", "latency_p99")}
    return rec


def phase_sim(card: str) -> dict:
    """Phase 16: WOW's simulator at ``device="cuda"`` held against itself
    at ``device="cpu"`` (see SIM_* above)."""
    from repro_torch.sim import RetryPolicy, TenantSpec, TrafficConfig
    from repro_torch.workloads import ALL_WORKFLOWS
    tag = "[sim]"
    t0 = time.perf_counter()
    paper = {}
    for name in ALL_WORKFLOWS:
        scale = SIM_SCALES.get(name, 1.0)
        r = paper[name] = sim_pair(name, name, scale, "wow")
        say(f"{tag} (a) {name} x{scale} wow: makespan {r['makespan']!r} "
            f"simulated s, {r['steps']} events, {r['actions']} actions; "
            f"wall {r['wall_s']['cuda']:.3f} s cuda, "
            f"{r['wall_s']['cpu']:.3f} s cpu [{card}]")
    t_a = time.perf_counter() - t0
    n_nodes, scale = SIM_SIZE
    cluster = {}
    for key, strategy, topo in (("wow flat", "wow", None),
                                ("wow site", "wow", SIM_SITE),
                                ("orig site", "orig", SIM_SITE)):
        r = cluster[key] = sim_pair(key, "group", scale, strategy,
                                    {"n_nodes": n_nodes, "topology": topo})
        say(f"{tag} (b) group x{scale} on {n_nodes} nodes, {key}: makespan "
            f"{r['makespan']!r} simulated s, {r['steps']} events, "
            f"{r['dense_fills']} dense fills; wall "
            f"{r['wall_s']['cuda']:.2f} s cuda "
            f"({r['events_per_s']['cuda']:.1f} events/s), "
            f"{r['wall_s']['cpu']:.2f} s cpu "
            f"({r['events_per_s']['cpu']:.1f} events/s) [{card}]")
    assert cluster["orig site"]["dense_fills"] > 0, \
        f"{tag} (b) orig on the site topology took no dense fill"
    t_b = time.perf_counter() - t0 - t_a
    churn = {}
    for strategy in ("orig", "cws", "wow"):
        r = churn[strategy] = sim_pair(f"churn {strategy}", "group",
                                       SIM_CHURN["scale"], strategy,
                                       churn=SIM_CHURN)
        say(f"{tag} (c) group x{SIM_CHURN['scale']} {strategy}, node "
            f"{SIM_CHURN['fail'][1]} fails at {SIM_CHURN['fail'][0]} s and "
            f"{SIM_CHURN['join'][1]} joins at {SIM_CHURN['join'][0]} s: "
            f"makespan {r['makespan']!r} simulated s; wall "
            f"{r['wall_s']['cuda']:.3f} s cuda, {r['wall_s']['cpu']:.3f} "
            f"s cpu [{card}]")
    traffic = TrafficConfig(
        tenants=(TenantSpec("alice", weight=2.0, workflows=("chain", "fork"),
                            scale=0.1, slo=300.0,
                            retry=RetryPolicy(max_attempts=3, backoff=20.0)),
                 TenantSpec("bob", weight=1.0, workflows=("group",),
                            scale=0.1, slo=400.0)),
        rate=0.2, n_arrivals=16, max_backlog=3, window=60.0, seed=0)
    tr = sim_pair("traffic", None, None, "wow", {"n_nodes": 16},
                  traffic=traffic)
    assert tr["traffic"]["retries"] > 0, tr["traffic"]
    say(f"{tag} (c) open-loop traffic, 2 tenants, 16 arrivals on 16 nodes, "
        f"wow: {tr['traffic']}; wall {tr['wall_s']['cuda']:.3f} s cuda, "
        f"{tr['wall_s']['cpu']:.3f} s cpu [{card}]")
    wall = time.perf_counter() - t0
    say(f"{tag} phase 16: {wall:.1f} s ((a) {t_a:.1f}, (b) {t_b:.1f}, (c) "
        f"{wall - t_a - t_b:.1f}); every result, log and TrafficResult "
        f"equal on cuda and cpu [{card}]")
    return {"card": card, "paper": paper, "scales": SIM_SCALES,
            "cluster": cluster, "size": list(SIM_SIZE), "site": SIM_SITE,
            "churn": churn, "traffic": tr, "wall_s": wall,
            "wall_s_by_part": {"a": t_a, "b": t_b,
                               "c": wall - t_a - t_b}}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing run", file=sys.stderr)
        return 1
    if "--src" in argv:            # another checkout's src, before ours
        sys.path.insert(0, str(Path(argv[argv.index("--src") + 1])
                               .resolve()))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.configs import get_config
    if "--world-one-meta" in argv:      # phase 12's process on meta
        return world_one_meta(argv[argv.index("--world-one-meta") + 1])

    card = phase_info()
    if "--ssd-only" in argv:
        return ssd_only(card)
    if "--flash-bwd-only" in argv:
        return flash_bwd_only(card)
    if "--moe-bwd-only" in argv:
        return moe_bwd_only(card, "--src" in argv)
    if "--ep-only" in argv:
        ep = phase_expert_parallel(card, None)
        say(json.dumps({"expert_parallel": ep}))
        return 0
    if "--tp-only" in argv:
        tp = phase_tensor_parallel(card, None)
        say(json.dumps({"tensor_parallel": tp}))
        return 0
    if "--fsdp-only" in argv:
        fsdp = phase_fsdp(card, None)
        say(json.dumps({"fsdp": fsdp}))
        return 0
    if "--seq-only" in argv:
        seq = phase_seq_split(card)
        say(json.dumps({"sequence_split": seq}))
        return 0
    if "--dryrun-only" in argv:
        dry = phase_mesh_dryrun(card)
        say(json.dumps({"mesh_dryrun": {k: v for k, v in dry.items()
                                        if k != "cells"}}))
        return 0
    if "--cp-only" in argv:
        cp = phase_context_parallel(card)
        say(json.dumps({"context_parallel": cp}))
        return 0
    if "--mamba-tp-only" in argv:
        mt = phase_mamba_tp(card, None)
        say(json.dumps({"mamba_tp": mt}))
        return 0
    if "--wow-only" in argv:
        wow = phase_wow(card)
        say(json.dumps({"wow": wow}))
        return 0
    if "--sim-only" in argv:
        sim = phase_sim(card)
        say(json.dumps({"sim": {k: v for k, v in sim.items()
                                if k != "paper"}}))
        return 0
    build = phase_build()
    flash_err = phase_kernels()
    bwd_err = phase_flash_backward()
    gmm_err = phase_gmm()
    gmm_bwd_err = phase_gmm_backward()
    ssd_err = phase_ssd()
    ssd_bwd_err = phase_ssd_backward()
    # the backwards' device times by launch, before the long phases
    gmm_passes, ssd_parts = gmm_bwd_passes(card), ssd_bwd_parts(card)
    phase_card_vs_cpu()
    train_card_vs_cpu()
    wide = train_wide_bf16_vs_f32()
    paths = [phase_serve(get_config("deepseek-7b"), card),
             phase_serve(get_config(LLAMA4).replace(n_layers=LLAMA4_LAYERS),
                         card),
             phase_serve(get_config(MAMBA2), card),
             phase_serve(get_config(ZAMBA2), card),
             phase_serve_batched(get_config(WHISPER), card),
             phase_serve_batched(get_config(LLAVA), card)]
    train = phase_train(card, get_config(TRAIN_ARCH))
    moe_train = phase_train(card, get_config(LLAMA4).replace(
        n_layers=MOE_TRAIN_LAYERS))
    ssm_train = phase_train(card, get_config(MAMBA2))
    hybrid_train = phase_train(card, get_config(ZAMBA2))
    encdec_train = phase_train_batched(card, get_config(WHISPER))
    vlm_train = phase_train_batched(card, get_config(LLAVA))
    paths += [train, moe_train, ssm_train, hybrid_train, encdec_train,
              vlm_train]
    timing = phase_timing(card)
    bwd = phase_timing_bwd(card)
    gmm = phase_timing_gmm(card)
    gmm_bwd = phase_timing_gmm_bwd(card, gmm_passes)
    ssd = phase_timing_ssd(card)
    ssd_bwd = phase_timing_ssd_bwd(card, ssd_parts)
    roofline = phase_roofline(paths, card)
    ep = phase_expert_parallel(card, moe_train["ms_per_step"])
    tp = phase_tensor_parallel(card, paths[0]["tokens"])
    fsdp = phase_fsdp(card, paths[0]["tokens"])
    seq = phase_seq_split(card)
    dry = phase_mesh_dryrun(card)
    cp = phase_context_parallel(card)
    mt = phase_mamba_tp(card, paths[2]["tokens"])
    wow = phase_wow(card)
    sim = phase_sim(card)

    def launches(name):
        by_path = {f"{p['arch']} x{p['n_layers']} {p.get('path', 'serve')}":
                   p["launches"][name]
                   for p in paths + ep["paths"] + tp["paths"]
                   + fsdp["paths"] + seq["paths"] + dry["paths"]
                   + cp["paths"] + mt["paths"]}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    dec = gmm["decode"]
    kernels = [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attn_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:24",
        **launches("flash_attn_fwd"), "max_abs_err": flash_err,
        **{k: timing["timed"][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "shape")},
        # deepseek's and zamba2's (hd 80) longest served prefills and
        # whisper's encoder (non-causal) beside the (1, 2048, 32, 128) one
        "graph_ms": timing["timed"]["graph_ms"],
        **{key: {k: timing[key][k] for k in
                 ("shape", "causal", "ms", "graph_ms", "plain_ms",
                  "bound_ms", "bound_by", "library_ms")}
           for key in ("served", "served_hd80", "whisper_encoder")},
    }, {
        "name": "flash_attn_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attn_bwd.cu",
        # no TPU kernel: the backward of the function of this one
        "replaces": "src/repro/kernels/flash_attention/kernel.py:24",
        **launches("flash_attn_bwd"), "max_abs_err": bwd_err,
        **{k: bwd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "graph_ms", "shape")},
        # the mma.sync body at the same shape, phi4-mini's GQA shape and
        # whisper's encoder (non-causal, wgmma body only at hd 64)
        "mma_body": bwd["mma"],
        "phi4_gqa": {k: bwd["by_shape"]["phi4 gqa"][k] for k in
                     ("shape", "ms", "graph_ms", "bound_ms", "bound_by",
                      "library_ms", "mma")},
        "whisper_encoder": {k: bwd["by_shape"]["whisper encoder"][k] for k in
                            ("shape", "causal", "ms", "graph_ms", "bound_ms",
                             "bound_by", "library_ms")},
    }, {
        "name": "moe_gmm", "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:24",
        **launches("moe_gmm"), "max_abs_err": gmm_err,
        # the decode shape with every row filled; the served decode
        # occupancy (decode_live) and the prefill beside it
        "ms": dec["ms"], "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
        "library_ms": None, "yardstick_ms": dec["yardstick_ms"],
        "shape": dec["shape"], "graph_ms": dec["graph_ms"],
        **{key: {k: gmm[key][k] for k in
                 ("label", "occupancy", "shape", "live_experts", "ms",
                  "graph_ms", "plain_ms", "bound_ms", "bound_by",
                  "yardstick_ms")}
           for key in ("prefill", "decode_live")},
        # llama4's training shape, every row live
        "train": {k: gmm_bwd["forward"][k] for k in
                  ("shape", "ms", "graph_ms", "plain_ms", "bound_ms",
                   "bound_by", "yardstick_ms")},
    }, {
        "name": "moe_gmm_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm_bwd.cu",
        # no TPU kernel: the backward of the function of this one
        "replaces": "src/repro/kernels/moe_gmm/kernel.py:24",
        **launches("moe_gmm_bwd"), "max_abs_err": gmm_bwd_err,
        **{k: gmm_bwd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "yardstick_ms", "graph_ms",
                                   "shape", "passes_ms")},
    }, {
        "name": "ssd_intra_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_intra_chunk.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:25",
        **launches("ssd_intra_chunk"), "max_abs_err": ssd_err,
        **{k: ssd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "yardstick_ms",
                               "f32_fma_bound_ms", "bytes_bound_ms",
                               "graph_ms", "shape")},
        # the one-chunk prompts of 254 and 92 tokens beside the 3-chunk one
        "one_chunk": {key: {k: r[k] for k in
                            ("shape", "ms", "graph_ms", "plain_ms",
                             "bound_ms", "bound_by", "yardstick_ms")}
                      for key, r in ssd["one_chunk"].items()},
    }, {
        "name": "ssd_intra_chunk_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_intra_chunk_bwd.cu",
        # no TPU kernel: the backward of the function of this one
        "replaces": "src/repro/kernels/ssd/kernel.py:25",
        **launches("ssd_intra_chunk_bwd"), "max_abs_err": ssd_bwd_err,
        **{k: ssd_bwd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "yardstick_ms",
                                   "f32_fma_bound_ms", "bytes_bound_ms",
                                   "graph_ms", "shape", "parts_ms",
                                   "issued_tflops")},
        # zamba2-2.7b's training shape beside mamba2-780m's
        "zamba2": {k: ssd_bwd["zamba2"][k] for k in
                   ("shape", "ms", "graph_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "yardstick_ms", "parts_ms",
                    "issued_tflops")},
    }]
    record = ROOT / "chiprun_out" / "chip_smoke.json"
    record.parent.mkdir(exist_ok=True)
    record.write_text(json.dumps({"card": card, "build": build,
                                  "paths": paths, "train": train,
                                  "train_bf16_vs_f32": wide,
                                  "flash_timing": timing,
                                  "flash_bwd_timing": bwd,
                                  "moe_gmm_timing": gmm,
                                  "moe_gmm_bwd_timing": gmm_bwd,
                                  "train_moe": moe_train,
                                  "train_ssm": ssm_train,
                                  "train_hybrid": hybrid_train,
                                  "train_encdec": encdec_train,
                                  "train_vlm": vlm_train,
                                  "ssd_timing": ssd,
                                  "ssd_bwd_timing": ssd_bwd,
                                  "roofline": roofline,
                                  "expert_parallel": ep,
                                  "tensor_parallel": tp,
                                  "fsdp": fsdp,
                                  "sequence_split": seq,
                                  "mesh_dryrun": dry,
                                  "context_parallel": cp,
                                  "mamba_tp": mt,
                                  "wow": wow,
                                  "sim": sim,
                                  "kernels": kernels},
                                 indent=1))
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
