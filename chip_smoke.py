#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MolKGNN (``molkgnn_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

  1. device:  require CUDA; print the card's name and power limit.
  2. build:   compile every CUDA source of molkgnn_torch/csrc with nvcc;
              print the scorer's registers, shared memory, spills and
              resident blocks per SM for each of its tile shapes, and the
              same for its backward's four kernels.
  3. kernels: hold the support-score kernel against its plain PyTorch
              version at the flagship serving shapes (buckets of 8192
              synthetic molecules at batch 1024: all degrees in one grouped
              launch, and each degree alone) and at the shapes of
              tests/test_pallas.py; time kernel, plain version, a library
              yardstick, and the card's bound for the same work. Kernel
              times are CUDA events around back-to-back wrapper calls (host
              cost included) beside the kernel's own device time from
              torch.profiler.
  4. serve:   the main path. Serve 8192 synthetic molecules at batch 1024
              through Predictor.predict_graphs with the flagship
              GNNModel(MolKGNNNet(use_kernel=True)) (4 layers, 10/20/30/50
              kernels, hidden 32, random weights from a seed); the grouped
              scorer must launch 4 times per chunk. Then the per-degree
              KernelConv(use_kernel=True) path, which launches the fused
              scorer once per degree. Then the kernel path against the
              plain-product form (use_kernel=False): at 1 layer on the
              synthetic molecules and at 4 layers on tie-free ones. Then
              the throughput of both forms and a profile of where the
              device time goes.
  5. train:   the training path, with the scorer's torch.autograd.Function
              (kernel forward, kernel backward: csrc/support_score_bwd.cu).
              (a) Its gradients at one flagship grouped launch of layer 0
              and one of an N-hop layer against autograd through einsum +
              max (max |diff| <= 1e-4 where the top two scores are more
              than 1e-4 apart); the backward kernels against their plain
              version (the dense route: a scatter and two products a group)
              on the same tensors, max |diff| <= 1e-5 * max(1, max |plain|)
              for each gradient, and against the dense route in fp64:
              max |x - x64| <= 2 max |cuBLAS fp32 - x64| + 2^-23 max |x64|
              for each group and gradient;
              the backward's time by events and its kernels' device time
              (profiler) per layer and a train step, beside its byte bound,
              the TF32 work its tensor-core kernels issue (and its time at
              495 TFLOP/s) and the dense route's; the memory a forward
              leaves behind.
              (b) 3 optimizer steps of the flagship with use_kernel=True
              and False from the same weights, batch 256 of tie-free
              molecules, dropout 0: losses within 1e-4 relative. (c) The
              main path: Trainer(...).fit() then .test() for the flagship
              (use_kernel=True) on make_synthetic_dataset(num_graphs=8192)
              at batch 1024 for 2 epochs; the grouped scorer must launch
              4 times per optimizer step plus 4 per evaluation batch, every
              step's loss be finite and the artifacts exist. (d) Train
              graphs/s of both forms (median step after the first) and a
              profile of one step. (e) A learning check on
              make_motif_dataset: the last epoch's train loss below the
              first's. (f) Graph replay: 8 flagship steps with dropout 0.25
              eager and through the captured CUDA graph (scan_steps=8) from
              the same weights, ids and generator seeds, losses within 1e-5
              relative and parameters within 1e-5; then train graphs/s of
              the flagship at batch 1024 eager, with scan_steps=16, and
              with scan_steps=16 and device_sampling (whole epochs of
              steps, each synchronised once; the scorer's launches counted
              as 4 a step, replays included), and CUDA events and a
              profile (idle share) over a block of 16 replays.
  6. cli:     the port's CLI, molkgnn_torch.cli.entry.main, end to end. An
              AID-1798 SDF pair of mirror-image conformers of 8 chiral
              scaffolds, written with the port's chemistry and labelled by
              handedness (molkgnn_torch/tools/enantiomer.py), cut to 187
              actives and 6,000 inactives (the tool runs the assay's full
              61,645); its ingest and cache timed. (a) The CLI's flagship
              defaults at batch 32 with --device_sampling --scan_steps 16
              for 2 epochs: artifacts, finite metrics, scorer launches = 4
              x (steps + evaluation batches), and --test on the same root
              giving the fit's test predictions within 1e-4. (b) The
              enantiomer configuration (1 layer, no dropout, peak 1e-2, 20
              epochs): test logAUC[0.001,0.1] and AUC, --test as in (a),
              and the train loss must fall. Then train graphs/s of that
              configuration at batch 32, eager against graph-replayed.
  7. screen:  library screening, import and export. (a) A library of
              phase 4's 8192 molecules repeated 16 times (131,072: slabs
              of 100,000 and 31,072) through Predictor.screen_library with
              the flagship (use_kernel=True) at batch 1024: the scorer
              launches 4 times a block (replays counted), each slab's
              host check and flat-packing seconds are printed, and
              screening graphs/s stands beside predict_graphs end to end
              and forward only, measured ABCCBA. On 2048 tie-free
              molecules over two slabs, screen_library's scores equal
              predict_graphs' within 1e-4. (b) A reference-layout .ckpt
              ({'state_dict': ...}, with the dead lin1/lin2/
              graph_embedding_linear keys and num_batches_tracked) of
              flagship weights goes through
              molkgnn_torch.cli.import_ckpt.main (exported on the card)
              and molkgnn_torch.cli.screen.main on phase 6's SDF records
              with a malformed one inserted: the CSV's scores equal a
              Predictor's with the same weights within 1e-4, the
              malformed record's cell is empty, and the scorer launches 4
              times a batch inside the exported program. (c) Evaluation
              at batch 32: phase 6(a)'s history.json evaluation seconds
              by epoch (its run is not repeated), and the flagship
              Trainer's evaluation of phase 6's 6,187 molecules (194
              batches of 32) captured against the eager batch loop it
              replaced, ABBA, with 4 launches a batch.
  8. points:  SchNet (8192 of phase 3's molecules), DimeNet++ (2048) and
              SphereNet (512) at their published widths (the encoders'
              defaults), random weights from the seed. For each: (a) host
              geometry and packing per 1,000 molecules; the batch, the
              largest power of two <= 1024 whose train step on the
              heaviest molecules peaks under 40 GiB, with its capacities;
              (b) Trainer.fit, 2 epochs with device sampling, eager against
              replayed (scan_steps=16): the first 3 losses within 1e-5
              relative, train graphs/s of both; (c) predict_graphs end to
              end, forward only and screen_library, graphs/s, ABCCBA; (d)
              8 molecules on the card against the CPU: fp64 within 1e-9,
              fp32 within 1e-4 of fp64 (relative to the largest value);
              (e) gather_points equal to batch_points bit for bit; (f) the
              mirror contract (SchNet and DimeNet++ invariant within 1e-5
              relative, SphereNet not); (g) both scorer wrappers launch 0
              times on every point path, counted; (h) SchNet through the
              import and screen CLIs, the CSV within 1e-4 of a Predictor;
              (i) the three enantiomer configurations through the CLI at
              6,000 inactives (molkgnn_torch/tools/enantiomer.py),
              printed beside the JAX-CPU records.
  9. chironet: ChIRoNet at its published widths (the encoder's defaults:
              F_H 64, EConv MLP (32, 32), GAT 64 then F_H with 4 heads,
              f_z (8, 8, 8), sigmoid c, sum reduction, molecule output),
              random weights from the seed, on the 29 scaffold SMILES of
              benchmarks/quality_run.py embedded under 8 seeds and repeated
              to 8192 molecules. (a) host featurisation (mol_to_chiro_graph)
              and packing per 1,000 molecules; the batch, as in phase 8;
              (b) Trainer.fit, 2 epochs with device sampling, eager against
              replayed (scan_steps=16): the first 3 losses within 1e-5
              relative, train graphs/s of both, the replayed step's CUDA
              events and idle share; (c) predict_graphs end to end,
              forward only and screen_library, graphs/s, ABCCBA; (d) 8
              molecules on the card against the CPU, for that model and
              one with chiral message passing and softmax c: fp64 within
              1e-9, fp32 within 1e-4 of fp64 (relative to the largest
              value); (e) gather_chiro equal to batch_chiro bit for bit;
              (f) the mirror contract on phase 6's mirror pairs: the R/S
              tags flip and the outputs move; (g) both scorer wrappers
              launch 0 times on every ChIRoNet path, counted; (h) ChIRoNet
              through the import and screen CLIs, the CSV within 1e-4 of a
              Predictor (records with no dihedral empty); (i) the
              enantiomer configuration through the CLI at 6,000 inactives,
              beside the JAX-CPU record.
 10. side:    (a) balanced batches: the flagship on phase 5's 8192
              molecules at batch 1024 under spec_for_dataset's tight spec
              (capacities and mean occupancy of each padded field against
              the cover spec); Trainer.fit with balanced_batches for 2
              epochs, eager against replayed (scan_steps=16) from the same
              weights, the first 3 losses within 1e-5 relative, the
              replayed fit counted (4 launches a step and an evaluation
              batch); train graphs/s and peak memory, balanced against
              cover, replayed, ABBA; on tie-free molecules balanced and
              cover evaluation of the same weights within 1e-4; with
              device_sampling it raises. (b) Fixed kernel sets (4/6/8/10
              for degrees 1-4, seeded) written to and read from a
              customized_kernels/ directory: the layer-0 launch of 8
              groups at batch-1024 shapes against the plain version, timed
              beside its bound, the library yardstick and the same layer's
              4 trainable groups; 3 optimizer steps and an evaluation,
              counted: the fixed tensors bit-equal, the score weights
              moved; capture_layer0_scores on the card within 1e-4 of the
              CPU on tie-free molecules. (c) The CLI with
              --balanced_batches --scan_steps 16 on phase 6's SDF pair at
              batch 32 for 1 epoch: artifacts, finite metrics, launches =
              4 x (steps + evaluation batches); with --device_sampling it
              is refused. (d) profiler_trace around two replayed steps
              writes a trace holding the scorer; a 2-point sweep (1 epoch,
              synthetic_motif) through molkgnn_torch.cli.entry
              subprocesses on the card, aggregated (2 rows), then resumed
              (both skipped).
 11. data parallel (molkgnn_torch/parallel, torch.distributed), the
              flagship at batch 1024 on phase 10's 8192 tie-free molecules:
              (a) Trainer(mesh=make_mesh(1)): one NCCL rank, scan_steps=16,
              the all-reduce captured inside the step; on host ids its
              first 3 steps against the single-device Trainer from the
              same weights and ids (losses and parameters within 1e-5);
              with device sampling (the rank-seeded stream) finite losses;
              an epoch of each counted (4 launches a step); train
              graphs/s of the four forms, the replayed step by CUDA events
              and its profile, both in turns; the bucket's bytes and the
              NCCL kernels' device ms a step. (b) Two ranks sharing the
              card over gloo (NCCL refuses two ranks on one device),
              spawned by molkgnn_torch.parallel.launch: gloo's all_reduce
              and all_gather on CUDA tensors; world-2 evaluation of 3
              blocks (padded to 4) against one device within 1e-5; 3 eager
              DP steps against a plain DP step in this process (both
              sub-batches' gradients and BatchNorm statistics averaged),
              parameters within 1e-5; rank 0's launches counted. (c)
              screen_library(mesh=make_mesh(1)) over phase 7's 131,072
              molecules, counted, graphs/s beside the single-device screen
              in turns; on 2048 tie-free molecules its scores against the
              single-device screen, and DP evaluation at world 1 against
              one device, within 1e-5. (d) molkgnn_torch.cli.entry under
              python -m torch.distributed.run --nproc_per_node 1 on phase
              6's SDF pair (--device_sampling --scan_steps 16, 1 epoch):
              one set of artifacts, finite metrics, the scorer launches
              from its task_info.log = 4 x (steps + evaluation batches);
              --test on its root gives its test predictions within 1e-4;
              --num_devices one above the cards (2 on a one-card machine)
              exits naming both numbers.
 12. model parallel (molkgnn_torch/parallel/halo.py, hybrid.py,
              edge_partition.py on torch.distributed), the flagship at
              batch 1024 on phase 10's 8192 tie-free molecules: (a) one
              NCCL rank, model_parallel="halo" with device sampling and
              scan_steps=16, the exchanges captured inside the step: its
              first 3 steps against the single-device device-sampling
              Trainer from the same weights and seed (losses and parameters
              within 1e-5), an epoch counted (4 launches a step), train
              graphs/s replayed beside the single-device replay in turns,
              the replays' CUDA events, idle share and top kernels; the
              host-fed halo epoch (graphs/s, counted) and the host
              partitioner's seconds a batch at 1 and 4 shards, with
              halo_stats at 4. (b) Four gloo ranks sharing the card, one
              spawn: halo at 4 shards on batches of 1024 against one
              device, within 1e-5: the eval forward; the first step's
              gradients (norm-wise relative); the 3 updates against one
              device's optimizer fed the ranks' gradients; against one
              device's own steps the parameters after the first and the
              BatchNorm statistics after 3; the later steps' gradients at
              the ranks' own state before each within 1e-3 (a trained
              model's near-tied permutation argmax may flip); the 3 steps'
              parameters against one device's own steps printed (Adam
              divides a gradient element of the order of its eps by
              itself); a 2x2 hybrid step against one device's step on the
              undivided 2048 graphs, and the edge-partition forward; rank
              0's launches counted, its ms a step and a gloo exchange's
              ms. (c) molkgnn_torch.cli.entry
              --model_parallel halo under torch.distributed.run
              --nproc_per_node 1 on phase 6's SDF pair (--device_sampling
              --scan_steps 16, 1 epoch): artifacts, finite metrics, the
              launches of its task_info.log = 4 x (steps + evaluation
              batches). (d) --model_parallel hybrid --num_devices 2 on a
              one-card machine exits naming 2 and 1.
 13. last modules: (a) molkgnn_torch.native: the g++ build into
              molkgnn_torch/build/ (seconds), have_native() true,
              floyd_warshall and gen_edge_input on the adjacency and edge
              features of phase 3's molecules (all 8192 through the
              library, host ms per 1,000 molecules; the first 1024 also
              through the numpy versions, which must agree bit for bit).
              (b) enantiomer_separation at the flagship's width on 64
              tie-free molecules with a degree-4 centre whose neighbours'
              features differ pairwise: the card's cosines against the
              CPU's with the same weights, fp64 with the kernel off within
              1e-9 and fp32 on the grouped scorer within 1e-5 (counted, 4
              a forward); at least one cosine under 0.99999. (c) SphereNet
              with use_node_features=False at its published widths, batch
              128 on phase 8's molecules: 3 eager train steps (finite
              losses; the node vector learns), the fp64 forward of 8
              molecules on the card against the CPU within 1e-9 (relative
              to the largest value, as in phase 8(d)), a state_dict round
              trip through the port's importer, eager train graphs/s
              beside the atom-table SphereNet in turns; 0 scorer launches,
              counted. (d) The flagship with matmul_dtype=torch.bfloat16
              at batch 1024 on phase 10's tie-free molecules, TF32 off:
              the eval forward on the card against the CPU within 1e-5 on
              the kernel route (counted) and within 1e-4 on the plain one
              (whose support operands are rounded too: a last-bit
              difference upstream flips some bf16 roundings), each more
              than 1e-4 from the card's fp32-product forward; replayed train
              graphs/s (scan_steps=16, device sampling) bf16 against fp32
              in turns.
 14. repeat:  the fixed-order segment sum (ops/segment.py,
              csrc/segment_sum.cu) and its plan builder
              (csrc/segment_plan.cu), through which every sum of two or
              more terms runs on the card. (a) Five cases of a batch of
              1024 of phase 3's molecules (message passing and its
              transpose at width 110, pooling at 32, the degree-4
              neighbour gather's gradient, one support tensor's perms
              gather gradient at 50 x 110), fp32 and fp64
              (molkgnn_torch/tools/segment_times.py): the sum bit-equal to
              its plain version on CPU copies (else the worst element is
              printed) and the plan kernel's plan equal to the plain plan;
              device ms of sum and plan (torch.profiler) beside their event
              ms, the byte bounds, index_add_, torch.sort and the plain
              versions. (b) On phase 3's molecules, ties included: three
              flagship forwards bit-equal (5 segment-sum launches and 2
              plans each); screen_library against predict_graphs, the
              largest gap printed; two eager epochs and two replayed epochs
              (scan_steps=8, dropout 0.25) from one state, each pair
              bit-equal, 73 sums, 11 plans and 4 scorer backward calls a
              step, eager against replayed within 1e-5. (c) SchNet,
              DimeNet++, SphereNet and ChIRoNet at their phase 8 and 9
              batches: forward and backward
              twice, predictions and gradients bit-equal. (d) The kernels
              of two profiled replays of the flagship step, printed: none
              of index_add_'s, index_put_'s or scatter_add_'s, no sort,
              only device sampling's searchsorted (6 a step); the scorer
              backward's kernels, device ms and launches a step.
              The segment sum's launches and the plans are counted from 0
              on every path that reads the scorer's counts
              (launch_counts()); phases 4 and 5's main paths and 14's must
              launch both (5 sums and 2 plans a forward, 73 and 11 a train
              step). The scorer's backward is counted from 0 on the same
              paths: 4 a train step on every kgnn training path (replays
              counted), none on a forward without autograd.

The last lines are the records of the phases' numbers, the kernel record
({"kernels": [...]}), the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

FP32_PEAK = 67e12  # FLOP/s, H100 SXM fp32 outside the tensor cores
HBM_RATE = 3.35e12  # bytes/s, H100 SXM HBM3
REPLACES = {
    "fused_support_score": "molkgnn_tpu/ops/pallas_kernels.py:295",
    "grouped_support_score": "molkgnn_tpu/ops/pallas_kernels.py:223",
}
KERNEL_SOURCE = "molkgnn_torch/csrc/support_score.cu"
BACKWARD_SOURCE = "molkgnn_torch/csrc/support_score_bwd.cu"
BACKWARD_REPLACES = ("molkgnn_tpu/ops/pallas_kernels.py:251 (_grouped_bwd, "
                     "the backward of _grouped_vjp; _fss_bwd at :76 is the "
                     "same at G = 1)")
# Substring of the backward's four __global__ functions (b packed for da,
# da, db's partial sums, their sum), as the profiler names them.
BACKWARD_NAME = "score_grad_"
SEGMENT_SOURCE = "molkgnn_torch/csrc/segment_sum.cu"
PLAN_SOURCE = "molkgnn_torch/csrc/segment_plan.cu"
# The segment sum replaces no TPU kernel: it sums in a fixed order what the
# JAX package sums with XLA's segment_sum.
SEGMENT_REPLACES = ("no TPU kernel: index_add_'s atomics; the JAX package's "
                    "XLA segment_sum, molkgnn_tpu/ops/segment.py:31")
# The plan builder replaces no TPU kernel either: the JAX package needs no
# plan.
PLAN_REPLACES = ("no TPU kernel: the plain torch chain (stable torch.sort, "
                 "searchsorted) of molkgnn_torch/ops/segment.py::"
                 "segment_plan_plain")
# Phase 14(d): substrings of the float-atomic sums' kernels (index_add_,
# index_put_'s sorting backward, scatter_add_, embedding's backward) as the
# profiler names them.
ATOMIC_SUMS = ("indexFunc", "index_put", "indexing_backward", "ReduceAdd",
               "embedding_backward", "atomic")
# Substring of both __global__ functions of the scorer's launch (the B
# packing and the scorer), as the profiler names them.
KERNEL_NAME = "support_score"
FLAGSHIP_KERNELS = (10, 20, 30, 50)
NUM_MOLECULES = 8192
BATCH = 1024
SEED = 0
# Inactive records of phase 6's SDF pair (AID 1798 has 61,645): the cut
# keeps the script within about 5 minutes; the full-count run is
# `python -m molkgnn_torch.tools.enantiomer`, with the same builder.
SMOKE_INACTIVES = 6000
# Phase 7(a): phase 4's molecules repeated into a library of 131,072.
SCREEN_REPEAT = 16
SLAB = 100_000
# Phase 8: molecules of phase 3's set per point family (host enumeration
# of triplets and torsion quads grows as atoms^3 and atoms^4), the device
# memory a train step of the chosen batch stays under, and the family
# taken through the import and screen CLIs.
POINT_MOLECULES = {"schnet": 8192, "dimenet_pp": 2048, "spherenet": 512}
POINT_MEMORY = 40 * 2**30
POINT_EXPORT = "schnet"
# Phase 9: ChIRoNet on the scaffold set of benchmarks/quality_run.py (its
# ACTIVE_SMILES and INACTIVE_SMILES, copied), each embedded under
# CHIRO_SEEDS seeds and the conformers repeated to NUM_MOLECULES.
ACTIVE_SMILES = [
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O", "CC(=O)Oc1ccccc1C(=O)O",
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C", "CC(=O)NC1=CC=C(O)C=C1",
    "ClC1=CC=C(C=C1)C(=O)O", "NC(=O)c1ccccc1", "CC(C)(C)c1ccc(O)cc1",
    "Oc1ccccc1",
]
INACTIVE_SMILES = [
    "CCO", "CC(=O)O", "CCN", "CCC", "CCCC", "CC(C)C", "CCOC", "CCS",
    "CNC", "COC", "CCCl", "CCBr", "CCF", "CC(N)=O", "CC(C)O", "CCCO",
    "CCCC(=O)O", "CCOC(=O)C", "CCCCCCCC", "CC1CCCCC1", "OCC(O)CO",
]
CHIRO_SEEDS = 8
# Phase 10(b): fixed (designed) kernels per degree at layer 0.
FIXED_KERNELS = (4, 6, 8, 10)
# Phase 12(b): the schedule's length for the hybrid step and one device's
# step at twice the batch, whose derived lengths would differ.
MP_ITERATIONS = 1000
# Phase 9(d)'s second model: chiral message passing with softmax c.
CHIRO_CMP = {"chiral_message_passing": True, "c_normalization": "softmax"}
# Phase 13: (a) phase 3's molecules also run through the numpy versions of
# the native utilities (whose gen_edge_input walks every path in Python,
# seconds per 1,000 molecules); (b) the enantiomer check's molecules; (c)
# SphereNet's batch (phase 8's).
NATIVE_CHECKED = 1024
ENANTIOMER_MOLECULES = 64
SPHERE_BATCH = 128
# The CLI epoch's evaluation at AID 1798's full counts while it ran eager,
# batch by batch: 194 batches of 32 in 6.6 s on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md, section 5); phase 7(c) prints its own beside it.
EAGER_EVAL_S = 6.6


def log(*args):
    print(*args, flush=True)


def reset_launches():
    """Set every counted wrapper's launch count to 0: the scorer's, the
    segment sum's and its plan builder's."""
    from molkgnn_torch.ops import segment as sg
    from molkgnn_torch.ops import support_score as ss

    for name in REPLACES:
        getattr(ss, name).launches = 0
    ss.support_score_backward.launches = 0
    sg.segment_sum.launches = 0
    sg.segment_plan.launches = 0


def launch_counts():
    """Each counted wrapper's launch count, by wrapper name: the scorer's
    two, its backward's ("support_score_backward"), "segment_sum" and
    "segment_plan" (plans built, one a plan)."""
    from molkgnn_torch.ops import segment as sg
    from molkgnn_torch.ops import support_score as ss

    counts = {name: getattr(ss, name).launches for name in REPLACES}
    counts["support_score_backward"] = ss.support_score_backward.launches
    counts["segment_sum"] = sg.segment_sum.launches
    counts["segment_plan"] = sg.segment_plan.launches
    return counts


def scorer_launches(counts):
    """The scorer wrappers' part of a ``launch_counts()`` dict."""
    return {name: counts[name] for name in REPLACES}


def check_backward(counts, steps, what, per_step=4):
    """The scorer backward's launches in a ``launch_counts()`` dict of a
    path that took ``steps`` train steps: ``per_step`` a step (one a
    layer; a fixed-set layer's 8 groups are one), replays counted, none for
    a forward without autograd."""
    n = counts["support_score_backward"]
    log(f"  {what}: scorer backward launches {n} (want {per_step * steps}: "
        f"{per_step} a train step, {steps} steps)")
    if n != per_step * steps:
        raise AssertionError(f"{what}: scorer backward launches {n}, want "
                             f"{per_step * steps}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call of ``fn`` over ``reps`` back-to-back
    calls, by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps: int = 20, name=KERNEL_NAME):
    """Device time per call of ``fn`` of the kernels whose name holds
    ``name`` (the scorer's by default; every kernel for None), from
    torch.profiler over ``reps`` calls; None where the profiler records no
    device time."""
    from molkgnn_torch.tools.segment_times import profiled_ms

    return profiled_ms(fn, reps, name)


def graph_ms(torch, fn, n: int = 50) -> float:
    """Device time of one call of ``fn`` by CUDA events around one replay
    of a CUDA graph that captured ``n`` calls: the launches run back to
    back with no host dispatch between them. (Late in this script's
    process torch.profiler was seen to report a third of a short kernel's
    time, below its bound, where this measure agreed with the profiler's
    reading in a fresh process, so phase 10 reports both.)"""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_rows(prof):
    """(self device ms, count, name) of each kernel in a profile; user
    annotations (e.g. ``Optimizer.step#AdamW.step``) are spans over
    kernels, not kernels, and are left out."""
    from torch.autograd import DeviceType

    return [
        (evt.self_device_time_total / 1e3, evt.count, evt.key)
        for evt in prof.key_averages()
        if evt.device_type == DeviceType.CUDA
        and evt.self_device_time_total > 0
        and not getattr(evt, "is_user_annotation", False)
    ]


def total(times):
    """Sum of times, or None where any of them was not measured."""
    times = list(times)
    return None if None in times else sum(times)


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound_ms(shapes):
    """Least time for the scorer's work on this card: the larger of the
    operations over the fp32 peak and the bytes (each input read once, each
    output written once) over the memory rate. shapes: [(M, K, L, P)]."""
    flops = sum(2 * m * k * l * p for m, k, l, p in shapes)
    nbytes = sum((m * k + p * k * l) * 4 + m * l * 8 for m, k, l, p in shapes)
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, (
        "operations" if t_ops >= t_bytes else "bytes"
    )


def graph_matrices(g):
    """A molecule's dense adjacency [n, n] (int64) and edge features
    [n, n, Fe] (float32, 0 where there is no edge)."""
    import numpy as np

    n, (src, dst) = g.num_nodes, g.edge_index
    adj = np.zeros((n, n), np.int64)
    adj[src, dst] = 1
    feat = np.zeros((n, n, g.edge_attr.shape[1]), np.float32)
    feat[src, dst] = g.edge_attr
    return adj, feat


def has_chiral_centre(g) -> bool:
    """Whether a node of degree 4 has neighbours with pairwise-distinct
    features (its mirror image then differs)."""
    import numpy as np

    src, dst = g.edge_index
    for v in np.flatnonzero(np.bincount(dst, minlength=g.num_nodes) == 4):
        x = g.x[src[dst == v]]
        if len({row.tobytes() for row in x}) == 4:
            return True
    return False


def as_double(batch):
    """A kgnn GraphBatch with its floating-point fields in float64."""
    import dataclasses

    cast = lambda t: t.double() if t.is_floating_point() else t
    return dataclasses.replace(
        batch, x=cast(batch.x), p=cast(batch.p),
        edge_attr=cast(batch.edge_attr), y=cast(batch.y),
        **{f"deg{d}": dataclasses.replace(
            b, nei_edge_attr=cast(b.nei_edge_attr))
           for d, b in enumerate(batch.buckets(), start=1)})


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.family_batches = {}

    def flagship(self, num_layers, use_kernel, seed=SEED, dropout=None,
                 **options):
        """The flagship GNNModel(MolKGNNNet) with random weights from
        ``seed``; ``dropout`` sets both dropout rates (default: the model's
        defaults, 0 in the encoder and 0.25 before the head); ``options``
        go to MolKGNNNet (fixed_kernels, sow_scores)."""
        from molkgnn_torch.models.kgnn import MolKGNNNet
        from molkgnn_torch.training.model import GNNModel

        gen = self.torch.Generator().manual_seed(seed)
        rates = {} if dropout is None else {"drop_ratio": dropout}
        head = {} if dropout is None else {"ffn_dropout_rate": dropout}
        enc = MolKGNNNet(num_layers=num_layers, use_kernel=use_kernel,
                         generator=gen, **rates, **options)
        return GNNModel(enc, generator=gen, **head)

    # ------------------------------------------------------------ phase 3
    def operands(self, m, d, f, l, gen):
        """Row-normalized operands of one degree bucket, as
        KernelConv.support_operands builds them."""
        from molkgnn_torch.ops.permutations import perm_table
        from molkgnn_torch.ops.similarity import normalize_rows

        torch = self.torch
        p = len(perm_table(d))
        x = torch.randn(m, d, f, generator=gen, device="cuda")
        s = torch.randn(l, p, d, f, generator=gen, device="cuda")
        a = normalize_rows(x).reshape(m, d * f)
        b = normalize_rows(s).reshape(l, p, d * f).permute(1, 2, 0)
        return a, b.contiguous()

    def check_against_plain(self, name, outs, a_list, b_list):
        """best within rtol/atol 1e-5 of the plain version; idx equal where
        the plain scores' top-2 gap exceeds 1e-4. Returns max |err|."""
        from molkgnn_torch.ops.support_score import support_score_plain

        torch = self.torch
        torch.cuda.synchronize()
        worst, excluded = 0.0, 0
        for (best, idx), a, b in zip(outs, a_list, b_list):
            want_best, want_idx = support_score_plain(a, b)
            torch.testing.assert_close(best, want_best, rtol=1e-5, atol=1e-5)
            worst = max(worst, (best - want_best).abs().max().item())
            sc = torch.einsum("mk,pkl->mlp", a, b)
            if sc.shape[2] > 1:
                top2 = sc.topk(2, dim=2).values
                clear = (top2[..., 0] - top2[..., 1]) > 1e-4
            else:
                clear = torch.ones_like(want_idx, dtype=torch.bool)
            excluded += int((~clear).sum())
            bad = int(((idx != want_idx) & clear).sum())
            if bad:
                raise AssertionError(f"{name}: {bad} argmax mismatches")
        log(f"  {name}: max |best - plain| = {worst:.3e}; "
            f"idx equal where top-2 gap > 1e-4 "
            f"({excluded} entries excluded)")
        return worst

    def time_launch(self, kernel_fn, a_list, b_list):
        """(kernel, plain, library, kernel device) ms for one launch over
        these groups."""
        from molkgnn_torch.ops.support_score import support_score_plain

        torch = self.torch

        def plain():
            for a, b in zip(a_list, b_list):
                support_score_plain(a, b)

        def library():  # one product per group, then max/argmax over p
            for a, b in zip(a_list, b_list):
                p, k, l = b.shape
                sc = torch.matmul(a, b.permute(1, 0, 2).reshape(k, p * l))
                sc.reshape(-1, p, l).max(dim=1)

        return (
            time_ms(torch, kernel_fn),
            time_ms(torch, plain),
            time_ms(torch, library),
            device_ms(torch, kernel_fn),
        )

    def time_dispatch(self, a_list, b_list):
        """The registered op's cost: one grouped launch through
        ``torch.ops.molkgnn.support_score`` against the same launch made
        directly (``_launch``, the ctypes call the op's CUDA version makes),
        ms each by CUDA events, in turns op, direct, direct, op. Back-to-back
        launches this small are paced by the host, so the difference is the
        op's host dispatch."""
        from molkgnn_torch.ops import support_score as ss

        torch = self.torch
        forms = {
            "op": lambda: ss.grouped_support_score(a_list, b_list),
            "direct": lambda: ss._launch(a_list, b_list),
        }
        times = {name: [] for name in forms}
        with torch.no_grad():
            for name in ("op", "direct", "direct", "op"):
                times[name].append(time_ms(torch, forms[name], reps=200))
        log(f"    op against direct launch: op {times['op']} ms, direct "
            f"{times['direct']} ms; op - direct "
            f"{min(times['op']) - min(times['direct']):.4f} ms (best of 2)")
        return times

    def log_times(self, what, t, shapes):
        b_ms, by = bound_ms(shapes)
        log(f"  {what}: kernel {t[0]:.4f} ms (device {fmt_ms(t[3])}), plain "
            f"{t[1]:.4f} ms, library {t[2]:.4f} ms, bound {b_ms:.4f} ms "
            f"({by}); kernel/library {t[0] / t[2]:.3f}, share of bound "
            f"{b_ms / t[0]:.3f}")

    def phase_kernels(self, spec):
        from molkgnn_torch.ops import support_score as ss
        from molkgnn_torch.ops.permutations import num_perms

        torch = self.torch
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        caps = spec.deg_capacity
        nhop_f = sum(FLAGSHIP_KERNELS)
        layer_shapes = {
            "layer 0": [(caps[d - 1], d, 28, FLAGSHIP_KERNELS[d - 1])
                        for d in range(1, 5)],
            "N-hop layer": [(caps[d - 1], d, nhop_f, FLAGSHIP_KERNELS[d - 1])
                            for d in range(1, 5)],
        }
        # (kernel, layer) -> ((kernel, plain, library, device) ms, shapes,
        # max err)
        self.per_request = {}
        self.op_dispatch = {}  # layer -> {"op": [ms], "direct": [ms]}
        for layer, dims in layer_shapes.items():
            ops = [self.operands(m, d, f, l, gen) for m, d, f, l in dims]
            a_list, b_list = [a for a, _ in ops], [b for _, b in ops]
            shapes = [(m, d * f, l, num_perms(d)) for m, d, f, l in dims]
            outs = ss.grouped_support_score(a_list, b_list)
            err = self.check_against_plain(
                f"grouped {layer} {shapes}", outs, a_list, b_list
            )
            ms = self.time_launch(
                lambda: ss.grouped_support_score(a_list, b_list),
                a_list, b_list,
            )
            self.per_request[("grouped_support_score", layer)] = (
                ms, shapes, err
            )
            self.log_times(f"grouped {layer}", ms, shapes)
            self.op_dispatch[layer] = self.time_dispatch(a_list, b_list)
            # Each degree alone, through the fused entry point (G = 1). The
            # per-degree KernelConv path launches it once per degree at the
            # layer-0 shapes.
            per_degree = []
            for d, (a, b, shape) in enumerate(zip(a_list, b_list, shapes), 1):
                err = self.check_against_plain(
                    f"fused {layer} degree {d} {shape}",
                    [ss.fused_support_score(a, b)], [a], [b],
                )
                t = self.time_launch(
                    lambda a=a, b=b: ss.fused_support_score(a, b), [a], [b]
                )
                self.log_times(f"{layer} degree {d} alone", t, [shape])
                per_degree.append((t, err))
            if layer == "layer 0":
                self.per_request[("fused_support_score", layer)] = (
                    tuple(
                        total(t[i] for t, _ in per_degree) for i in range(4)
                    ),
                    shapes, max(e for _, e in per_degree),
                )

        # The shapes of tests/test_pallas.py. Operands are unit vectors
        # along k, so every score is a cosine in [-1, 1], as on the model's
        # path, and the 1e-5 tolerance is against values of order 1.
        from molkgnn_torch.ops.similarity import normalize_rows

        test_pallas_shapes = [(37, 112, 50, 12), (8, 28, 3, 2), (200, 440, 30, 6)]
        for m, k, l, p in test_pallas_shapes:
            a = normalize_rows(torch.randn(m, k, generator=gen, device="cuda"))
            b = normalize_rows(
                torch.randn(p, l, k, generator=gen, device="cuda")
            ).transpose(1, 2).contiguous()
            out = ss.fused_support_score(a, b)
            self.check_against_plain(f"fused {(m, k, l, p)}", [out], [a], [b])
            t = self.time_launch(
                lambda: ss.fused_support_score(a, b), [a], [b]
            )
            self.log_times(f"fused {(m, k, l, p)}", t, [(m, k, l, p)])
        ones_a = torch.ones(4, 8, device="cuda")
        ones_b = torch.ones(5, 8, 3, device="cuda")
        for _, idx in [ss.fused_support_score(ones_a, ones_b),
                       *ss.grouped_support_score([ones_a] * 2, [ones_b] * 2)]:
            if not bool((idx == 0).all()):
                raise AssertionError("tie case: argmax is not the first p")
        log("  tie case: every idx is 0")

    # ------------------------------------------------------------ phase 4
    def phase_serve(self, graphs, spec):
        from molkgnn_torch.data.synthetic import tie_free_molgraph
        from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
        from molkgnn_torch.models.kgnn import KernelConv
        from molkgnn_torch.ops import segment as sg
        from molkgnn_torch.ops import support_score as ss
        from molkgnn_torch.serving.predictor import Predictor

        import numpy as np

        torch = self.torch
        card = torch.cuda.get_device_name(0)
        flagship = self.flagship

        # --- the main path, counted -------------------------------------
        model = flagship(4, True)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        served = Predictor(model, sd, spec, device="cuda")
        chunks = -(-len(graphs) // spec.num_graphs)
        reset_launches()
        scores = served.predict_graphs(graphs)
        launches = {
            "grouped_support_score": ss.grouped_support_score.launches,
            "fused_support_score": ss.fused_support_score.launches,
        }
        self.main_segment_launches = sg.segment_sum.launches
        self.main_plan_launches = sg.segment_plan.launches
        log(f"  main path: {chunks} chunks, launches {launches}, segment "
            f"sum {self.main_segment_launches} (want 5 a chunk), plans "
            f"{self.main_plan_launches} (want 2 a chunk)")
        if launches["grouped_support_score"] != 4 * chunks:
            raise AssertionError(
                f"grouped scorer launched {launches['grouped_support_score']}"
                f" times, want 4 x {chunks}"
            )
        if self.main_segment_launches != 5 * chunks:
            raise AssertionError("the segment sum did not launch 5 times a "
                                 "chunk (4 layers and the pooling)")
        if self.main_plan_launches != 2 * chunks:
            raise AssertionError("the plan kernel did not build 2 plans a "
                                 "chunk (the edges' and the pooling's)")
        if scores.shape != (len(graphs),) or not np.isfinite(scores).all():
            raise AssertionError("scores are not finite or misshapen")
        self.main_launches = launches
        check_backward(launch_counts(), 0, "serving main path")

        # --- the per-degree KernelConv path, counted ----------------------
        batch = batch_graphs(graphs[:BATCH], spec).to("cuda")
        gen = torch.Generator().manual_seed(SEED)
        convs = [
            KernelConv(d, FLAGSHIP_KERNELS[d - 1], 28, 7, use_kernel=True,
                       generator=gen).cuda()
            for d in range(1, 5)
        ]
        ss.grouped_support_score.launches = 0
        ss.fused_support_score.launches = 0
        with torch.inference_mode():
            for conv, b in zip(convs, batch.buckets()):
                out = conv(batch.x[b.focal_index], batch.p[b.focal_index],
                           batch.x[b.nei_index], batch.p[b.nei_index],
                           b.nei_edge_attr, b.mask, is_last_layer=True)
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError("KernelConv scores are not finite")
        self.conv_launches = ss.fused_support_score.launches
        log(f"  KernelConv path: fused launches {self.conv_launches}")
        if self.conv_launches != 4:
            raise AssertionError("KernelConv path did not launch 4 times")

        # --- kernel path against the plain-product form -------------------
        def compare(name, num_layers, mols, mspec, rtol, atol):
            m_k = flagship(num_layers, True, seed=1)
            sd_k = m_k.state_dict()
            got = Predictor(m_k, sd_k, mspec, "cuda").predict_graphs(
                mols, return_embeddings=True
            )
            want = Predictor(
                flagship(num_layers, False, seed=1), sd_k, mspec, "cuda"
            ).predict_graphs(mols, return_embeddings=True)
            for what, g, w in zip(("scores", "embeddings"), got, want):
                diff = float(np.abs(g - w).max())
                log(f"  {name} {what}: max |kernel - plain form| = "
                    f"{diff:.3e} (max |value| {float(np.abs(w).max()):.3e})")
                np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)

        compare("1 layer, synthetic", 1, graphs, spec, 1e-4, 1e-4)
        rng = np.random.default_rng(SEED)
        tie_free = [tie_free_molgraph(rng) for _ in range(2048)]
        compare("4 layers, tie-free", 4, tie_free,
                spec_for_graphs(tie_free, 512), 1e-4, 1e-4)

        # --- throughput of both forms -------------------------------------
        n_edges = sum(g.num_edges for g in graphs)
        models = {True: served}
        models[False] = Predictor(flagship(4, False), sd, spec, device="cuda")
        batches = [
            batch_graphs(graphs[s:s + BATCH], spec).to("cuda")
            for s in range(0, len(graphs), BATCH)
        ]
        results = {True: {"e2e": [], "device": []},
                   False: {"e2e": [], "device": []}}
        for use_kernel in (True, False, False, True, True, False):
            pred = models[use_kernel]
            t0 = time.perf_counter()
            pred.predict_graphs(graphs)
            results[use_kernel]["e2e"].append(time.perf_counter() - t0)
            with torch.inference_mode():
                pred.model(batches[0])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in batches:
                    pred.model(b)
                torch.cuda.synchronize()
            results[use_kernel]["device"].append(time.perf_counter() - t0)
        self.throughput = {}
        for use_kernel, r in results.items():
            row = {}
            for kind, secs in r.items():
                best = min(secs)
                row[kind] = {
                    "seconds": secs,
                    "graphs_per_s": len(graphs) / best,
                    "edges_per_s": n_edges / best,
                }
            self.throughput[f"use_kernel={use_kernel}"] = row
            log(f"  use_kernel={use_kernel} on {card}: "
                f"predict_graphs {row['e2e']['graphs_per_s']:.1f} graphs/s, "
                f"{row['e2e']['edges_per_s']:.1f} edges/s; forward only "
                f"{row['device']['graphs_per_s']:.1f} graphs/s, "
                f"{row['device']['edges_per_s']:.1f} edges/s "
                f"({len(graphs)} molecules, {n_edges} edges, batch {BATCH}; runs "
                f"{r['e2e']} s and {r['device']} s)")
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        log(f"  peak device memory {peak_mib:.1f} MiB")
        self.profile(models, batches)

    def profile(self, models, batches):
        """Device time by kernel over one forward pass of all chunks."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        for use_kernel, pred in models.items():
            with torch.inference_mode():
                pred.model(batches[0])
                torch.cuda.synchronize()
                with profile(
                    activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                ) as prof:
                    t0 = time.perf_counter()
                    for b in batches:
                        pred.model(b)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
            rows = device_rows(prof)
            busy = sum(r[0] for r in rows)
            if not rows:
                log(f"  profile use_kernel={use_kernel}: no device time "
                    "recorded (not measured)")
                continue
            log(f"  profile use_kernel={use_kernel}: device busy "
                f"{busy:.3f} ms of {wall_ms:.3f} ms wall "
                f"(idle share {1 - busy / wall_ms:.3f}, profiler on)")
            scorer = sum(r[0] for r in rows if KERNEL_NAME in r[2])
            log(f"    scorer kernel {scorer:.3f} ms of {busy:.3f} ms busy "
                f"(share {scorer / busy:.3f})")
            for ms, count, key in sorted(rows, reverse=True)[:10]:
                log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")

    # ------------------------------------------------------------ phase 5
    def grad_check(self, spec):
        """The Function's gradients at flagship grouped launches against
        autograd through the plain version; its backward's time; what a
        forward leaves allocated once its outputs are dropped."""
        from molkgnn_torch.ops import support_score as ss
        from molkgnn_torch.ops.permutations import num_perms
        from molkgnn_torch.tools.backward_profile import bound, tf32_work

        torch = self.torch
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        caps = spec.deg_capacity
        nhop_f = sum(FLAGSHIP_KERNELS)
        self.backward_ms = {}
        tf32 = {}
        for layer, f in (("layer 0", 28), ("N-hop layer", nhop_f)):
            dims = [(caps[d - 1], d, f, FLAGSHIP_KERNELS[d - 1])
                    for d in range(1, 5)]
            ops = [self.operands(m, d, ff, l, gen) for m, d, ff, l in dims]
            a_list, b_list = [a for a, _ in ops], [b for _, b in ops]
            g_list, excluded = [], 0
            for a, b in ops:
                sc = torch.einsum("mk,pkl->mlp", a, b)
                if sc.shape[2] > 1:
                    top2 = sc.topk(2, dim=2).values
                    clear = (top2[..., 0] - top2[..., 1]) > 1e-4
                else:
                    clear = torch.ones(sc.shape[:2], dtype=torch.bool,
                                       device="cuda")
                excluded += int((~clear).sum())
                g = torch.randn(sc.shape[:2], generator=gen, device="cuda")
                g_list.append(torch.where(clear, g, 0.0))
            ta = [a.clone().requires_grad_() for a in a_list]
            tb = [b.clone().requires_grad_() for b in b_list]
            torch.cuda.synchronize()
            held0 = torch.cuda.memory_allocated()
            outs = ss.grouped_support_score(ta, tb)
            torch.cuda.synchronize()
            held1 = torch.cuda.memory_allocated()
            bests = [best for best, _ in outs]
            loss = sum((best * g).sum() for best, g in zip(bests, g_list))
            del outs, bests
            torch.cuda.synchronize()
            held2 = torch.cuda.memory_allocated()
            loss.backward()
            pa = [a.clone().requires_grad_() for a in a_list]
            pb = [b.clone().requires_grad_() for b in b_list]
            sum(
                (torch.einsum("mk,pkl->mlp", a, b).max(dim=2).values * g)
                .sum() for a, b, g in zip(pa, pb, g_list)
            ).backward()
            err_a = max((x.grad - y.grad).abs().max().item()
                        for x, y in zip(ta, pa))
            err_b = max((x.grad - y.grad).abs().max().item()
                        for x, y in zip(tb, pb))
            log(f"  gradient check, grouped {layer}: max |da - plain| = "
                f"{err_a:.3e}, max |db - plain| = {err_b:.3e} ({excluded} "
                f"entries within 1e-4 of a tie given no gradient)")
            if max(err_a, err_b) > 1e-4:
                raise AssertionError(f"{layer}: gradient differs by > 1e-4")
            log(f"    a forward allocates {(held1 - held0) / 2**20:.2f} MiB; "
                f"with its outputs dropped and the graph kept, "
                f"{(held2 - held0) / 2**20:.2f} MiB stay (the argmaxes "
                f"{sum(4 * m * l for m, _, _, l in dims) / 2**20:.2f} MiB, "
                "the loss's terms)")
            flat = ss._SupportScore.apply(ss.grouped_support_score, 4, *ta, *tb)
            idxs = [x.detach() for x in flat[4:]]
            before = ss.support_score_backward.launches
            das, dbs = ss.support_score_backward(a_list, b_list, g_list, idxs)
            if ss.support_score_backward.launches != before + 1:
                raise AssertionError("the backward did not launch once")
            err, worst, far = 0.0, 0.0, []
            for got, a, b, g, idx in zip(zip(das, dbs), a_list, b_list,
                                         g_list, idxs):
                exact = ss.support_score_backward_plain(
                    a.double(), b.double(), g.double(), idx)
                for x, w, x64 in zip(got, ss.support_score_backward_plain(
                        a, b, g, idx), exact):
                    diff = (x - w).abs().max().item()
                    err = max(err, diff)
                    worst = max(worst,
                                diff / max(1.0, w.abs().max().item()))
                    far.append(((x.double() - x64).abs().max().item(),
                                (w.double() - x64).abs().max().item(),
                                2.0 ** -23 * x64.abs().max().item()))
            log(f"    backward kernels against the plain version on the "
                f"same tensors: max |diff| {err:.3e}, max |diff| / max(1, "
                f"max |plain|) {worst:.3e} (limit 1e-5, each gradient)")
            if worst > 1e-5:
                raise AssertionError(f"{layer}: backward kernels differ from "
                                     "the plain version")
            # Against the dense route in fp64: within twice cuBLAS fp32's
            # distance plus an fp32 ulp of max |x64|, each group and
            # gradient (da, db in turn).
            log("    max |x - x64| of the kernels; of cuBLAS fp32 (da, db a "
                "group): " + "; ".join(
                    f"{k:.3e}, {c:.3e}" for k, c, _ in far))
            if any(k > 2 * c + ulp for k, c, ulp in far):
                raise AssertionError(f"{layer}: backward kernels farther "
                                     "from fp64 than twice cuBLAS fp32")

            def backward():
                return torch.autograd.grad(flat[:4], ta + tb, g_list,
                                           retain_graph=True)

            def dense():
                return [ss.support_score_backward_plain(a, b, g, idx)
                        for a, b, g, idx in zip(a_list, b_list, g_list,
                                                idxs)]

            shapes = [(m, d * ff, l, num_perms(d)) for m, d, ff, l in dims]
            rec = {"ms": time_ms(torch, backward),
                   "device_ms": device_ms(torch, backward,
                                          name=BACKWARD_NAME),
                   "device_all_ms": device_ms(torch, backward, name=None),
                   "plain_ms": time_ms(torch, dense),
                   "plain_device_ms": device_ms(torch, dense, name=None),
                   "bound_ms": bound(shapes)["ms"],
                   "max_abs_err": err, "max_rel_err": worst}
            # The TF32 work goes to the log only: it is counted from the
            # tiles, not measured, so the kernel record leaves it out.
            work = tf32_work(shapes, device_ms=rec["device_ms"])
            tf32[layer] = work
            self.backward_ms[layer] = rec
            log(f"    backward (the kernels): {rec['ms']:.4f} ms by events "
                f"({fmt_ms(rec['device_ms'])} of device time), bound "
                f"{rec['bound_ms']:.4f} ms (bytes); the dense plain route "
                f"(a scatter and two products a group) {rec['plain_ms']:.4f}"
                f" ms by events ({fmt_ms(rec['plain_device_ms'])} of device "
                f"time)")
            log(f"    issued TF32 work (one-hot products at the kernels' "
                f"tiles, 3xTF32): {work['flops'] / 1e9:.3f} GFLOP, "
                f"{work['ms']:.4f} ms at 495 TFLOP/s"
                + (f", {work['share']:.3f} of the kernels' device time"
                   if work["share"] else ""))

        def step(key):
            parts = [self.backward_ms["layer 0"][key]] + 3 * [
                self.backward_ms["N-hop layer"][key]]
            return total(parts)

        def step_tf32(key):
            return tf32["layer 0"][key] + 3 * tf32["N-hop layer"][key]

        self.backward_step = {key: step(key) for key in (
            "ms", "device_ms", "device_all_ms", "plain_ms", "plain_device_ms",
            "bound_ms")}
        self.backward_step["max_abs_err"] = max(
            r["max_abs_err"] for r in self.backward_ms.values())
        self.backward_step_ms = self.backward_step["ms"]
        log(f"  backward per flagship train step (layer 0 + 3 N-hop): "
            f"{self.backward_step_ms:.4f} ms by events, "
            f"{fmt_ms(self.backward_step['device_ms'])} of device time in "
            f"its kernels ({fmt_ms(self.backward_step['device_all_ms'])} in "
            f"every kernel of the call), bound "
            f"{self.backward_step['bound_ms']:.4f} ms; dense plain "
            f"route {self.backward_step['plain_ms']:.4f} ms by events, "
            f"{fmt_ms(self.backward_step['plain_device_ms'])} of device time;"
            f" issued TF32 work {step_tf32('flops') / 1e9:.3f} GFLOP, "
            f"{step_tf32('ms'):.4f} ms at 495 TFLOP/s")

    def kernel_vs_plain_training(self):
        """3 optimizer steps with the kernel and with the plain products
        from the same weights: losses within 1e-4 relative, and parameters
        within 1e-5. Adam moves a weight by about the learning rate
        (1.7e-3 at step 1) whatever its gradient's size, so a gradient term
        lost on one side shows as a difference of that order."""
        import numpy as np

        from molkgnn_torch.data.dataset import make_tie_free_dataset
        from molkgnn_torch.graphs.batch import spec_for_graphs
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        ds = make_tie_free_dataset(800, 768, seed=SEED)
        spec = spec_for_graphs(ds.graphs, 256)
        cfg = TrainConfig(batch_size=256, warmup_iterations=3,
                          progress=False)
        trainers = {}
        for use_kernel in (True, False):
            model = self.flagship(4, use_kernel, seed=SEED + 1, dropout=0.0)
            trainers[use_kernel] = Trainer(model, ds, spec, cfg)
        trainers[False].model.load_state_dict(
            trainers[True].model.state_dict())
        for step in range(3):
            ids = np.arange(256 * step, 256 * (step + 1), dtype=np.int32)
            losses = {k: float(t._step_ids(ids)) for k, t in
                      trainers.items()}
            rel = abs(losses[True] - losses[False]) / abs(losses[False])
            log(f"  step {step + 1}: loss kernel {losses[True]:.7f}, plain "
                f"{losses[False]:.7f} (relative difference {rel:.2e})")
            if rel > 1e-4:
                raise AssertionError("kernel and plain losses differ")
        sd = trainers[False].model.state_dict()
        diff = max(
            (v - sd[k]).abs().max().item()
            for k, v in trainers[True].model.state_dict().items()
        )
        log(f"  largest parameter difference after 3 steps: {diff:.3e} "
            f"(learning rate of step 3: {trainers[True].schedule(2):.3e})")
        if diff > 1e-5:
            raise AssertionError("kernel and plain parameters differ by "
                                 "more than 1e-5 after 3 steps")

    def main_train_path(self, tmp):
        """Trainer.fit() + .test(), counted (see the module doc)."""
        import numpy as np

        from molkgnn_torch.data.dataset import make_synthetic_dataset
        from molkgnn_torch.graphs.batch import spec_for_graphs
        from molkgnn_torch.ops import segment as sg
        from molkgnn_torch.ops import support_score as ss
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        t0 = time.perf_counter()
        ds = make_synthetic_dataset(num_graphs=NUM_MOLECULES)
        spec = spec_for_graphs(ds.graphs, BATCH)
        log(f"  make_synthetic_dataset({NUM_MOLECULES}) in "
            f"{time.perf_counter() - t0:.1f} s; split sizes "
            f"{ {k: len(v) for k, v in ds.split.items()} }")
        cfg = TrainConfig(
            batch_size=BATCH, max_epochs=2, progress=False,
            log_dir=os.path.join(tmp, "logs"),
            checkpoint_dir=os.path.join(tmp, "ckpt"),
        )
        trainer = Trainer(self.flagship(4, True), ds, spec, cfg)
        if trainer.device.type != "cuda":
            raise AssertionError("the Trainer did not default to the card")
        reset_launches()
        t0 = time.perf_counter()
        history = trainer.fit()
        tested = trainer.test()
        secs = time.perf_counter() - t0
        launches = {
            "grouped_support_score": ss.grouped_support_score.launches,
            "fused_support_score": ss.fused_support_score.launches,
        }
        self.train_segment_launches = sg.segment_sum.launches
        self.train_plan_launches = sg.segment_plan.launches
        if not self.train_segment_launches:
            raise AssertionError("the segment sum did not launch in training")
        eval_batches = (
            cfg.max_epochs * -(-len(ds.split["valid"]) // BATCH)
            + len(tested) * -(-len(ds.split["test"]) // BATCH)
        )
        want = 4 * trainer.step + 4 * eval_batches
        want_sums = 73 * trainer.step + 5 * eval_batches
        want_plans = 11 * trainer.step + 2 * eval_batches
        log(f"  main path: fit + test in {secs:.2f} s, {trainer.step} "
            f"optimizer steps, {eval_batches} evaluation batches, "
            f"launches {launches} (want {want} grouped), segment sum "
            f"{self.train_segment_launches} (want {want_sums}: 73 a step, 5 "
            f"an evaluation batch), plans {self.train_plan_launches} (want "
            f"{want_plans}: 11 a step, 2 an evaluation batch)")
        if (self.train_segment_launches != want_sums
                or self.train_plan_launches != want_plans):
            raise AssertionError("segment sums or plans a step or batch "
                                 "are not 73 and 11, 5 and 2")
        if launches["grouped_support_score"] != want:
            raise AssertionError("grouped launches are not 4 per step and "
                                 "per evaluation batch")
        self.train_backward_launches = ss.support_score_backward.launches
        check_backward(launch_counts(), trainer.step, "main path")
        losses = np.array(trainer.step_losses)
        if losses.shape != (trainer.step,) or not np.isfinite(losses).all():
            raise AssertionError(f"step losses not all finite: {losses}")
        n_train = len(ds.split["train"])  # graphs drawn per epoch
        for e in history:
            train_s = e["train_dispatch_time_s"] + e["train_readback_time_s"]
            log(f"  epoch {e['epoch']}: train_loss {e['train_loss']:.5f}, "
                f"valid loss {e['loss']:.5f}, AUC {e['AUC']:.4f}; epoch "
                f"{e['epoch_time_s']:.3f} s (steps "
                f"{e['train_dispatch_time_s']:.3f}, readback "
                f"{e['train_readback_time_s']:.3f}, eval "
                f"{e['eval_time_s']:.3f}); train {n_train / train_s:.1f} "
                f"graphs/s over steps and readback")
        log(f"  test: " + ", ".join(
            f"{tag} AUC {m['AUC']:.4f}" for tag, m in tested.items()))
        files = ["logs/history.json", "logs/test_result.log"] + [
            f"logs/test_sample_scores_{tag}.log" for tag in tested
        ] + [f"ckpt/{tag}.pt" for tag in trainer._ckpts]
        missing = [f for f in files
                   if not os.path.exists(os.path.join(tmp, f))]
        if missing:
            raise AssertionError(f"missing artifacts: {missing}")
        log(f"  artifacts: {', '.join(files)}")
        self.train_launches = launches
        self.train_data = (ds, spec)

    def train_throughput(self):
        """Train graphs/s of both forms, forms in turns: the graphs of a
        run of steps over its wall time, the steps launched back to back
        and the card synchronised once at the end, as fit() runs them; and,
        as a per-step statistic, the median of synchronised steps after
        the first."""
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        torch = self.torch
        ds, spec = self.train_data
        cfg = TrainConfig(batch_size=BATCH, progress=False)
        trainers = {k: Trainer(self.flagship(4, k), ds, spec, cfg)
                    for k in (True, False)}
        batches = [ids for ids in trainers[True]._epoch_id_batches()
                   if (ids >= 0).all()]
        for trainer in trainers.values():  # warm: first products, allocator
            trainer._step_ids(batches[0])
        rates = {True: [], False: []}
        steps = {True: [], False: []}
        for use_kernel in (True, False, False, True):
            trainer = trainers[use_kernel]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for ids in batches:
                trainer._step_ids(ids)
            torch.cuda.synchronize()
            rates[use_kernel].append(
                len(batches) * BATCH / (time.perf_counter() - t0))
            run = []
            for ids in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer._step_ids(ids)
                torch.cuda.synchronize()
                run.append(time.perf_counter() - t0)
            steps[use_kernel].append(run)
        card = torch.cuda.get_device_name(0)
        self.train_throughput_record = {}
        for use_kernel in (True, False):
            medians = [statistics.median(r[1:]) for r in steps[use_kernel]]
            self.train_throughput_record[f"use_kernel={use_kernel}"] = {
                "graphs_per_s": rates[use_kernel],
                "median_step_s": medians,
                "step_s": steps[use_kernel],
            }
            log(f"  use_kernel={use_kernel} on {card}: train "
                f"{', '.join(f'{r:.1f}' for r in rates[use_kernel])} "
                f"graphs/s (two runs of {len(batches)} steps at batch "
                f"{BATCH}, one synchronisation each); synchronised steps: "
                f"median after the first "
                f"{', '.join(f'{m * 1e3:.3f}' for m in medians)} ms, steps "
                f"{[[round(t, 5) for t in r] for r in steps[use_kernel]]} s")
        self.profile_step(trainers[True], batches[0])

    def profile_step(self, trainer, ids):
        """torch.profiler over one train step: the device time of its
        forward, backward and optimizer (each in its own window) and, over
        the whole step, the idle share, the scorer's share and the top 10
        kernels."""
        from torch.profiler import ProfilerActivity, profile

        from molkgnn_torch.graphs.device_pack import gather_batch

        torch = self.torch
        self.step_profile = None

        def busy(prof):
            rows = device_rows(prof)
            return sum(r[0] for r in rows), rows

        def window(fn):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            return out, busy(prof), wall

        ids_dev = torch.as_tensor(ids, device="cuda")
        trainer._step_ids(ids)  # warm
        parts, walls = {}, {}
        batch, parts["gather"], walls["gather"] = window(
            lambda: gather_batch(trainer._device_data, ids_dev, trainer.spec))
        loss, parts["forward"], walls["forward"] = window(
            lambda: trainer._loss(batch))
        _, parts["backward"], walls["backward"] = window(loss.backward)
        _, parts["optimizer"], walls["optimizer"] = window(trainer._update)
        log("  one step by part (own profiler windows), device ms of wall "
            "ms: " + ", ".join(f"{k} {v[0]:.3f} of {walls[k]:.3f}"
                               for k, v in parts.items()))
        _, (total, rows), wall = window(lambda: trainer._step_ids(ids))
        if not rows:
            log("  profile: no device time recorded (not measured)")
            return
        scorer = sum(r[0] for r in rows if KERNEL_NAME in r[2])
        log(f"  whole step: device busy {total:.3f} ms of {wall:.3f} ms "
            f"wall (idle share {1 - total / wall:.3f}, profiler on); scorer "
            f"{scorer:.3f} ms (share {scorer / total:.3f})")
        for ms, count, key in sorted(rows, reverse=True)[:10]:
            log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")
        self.step_profile = {k: v[0] for k, v in parts.items()}
        self.step_profile.update(step_busy_ms=total, step_wall_ms=wall,
                                 scorer_ms=scorer)

    def learning_check(self, tmp):
        from molkgnn_torch.data.dataset import make_motif_dataset
        from molkgnn_torch.graphs.batch import spec_for_graphs
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        ds = make_motif_dataset(seed=SEED, num_graphs=2048)
        spec = spec_for_graphs(ds.graphs, 256)
        cfg = TrainConfig(batch_size=256, max_epochs=8, warmup_iterations=10,
                          peak_lr=5e-2, progress=False,
                          log_dir=os.path.join(tmp, "motif"))
        history = Trainer(self.flagship(4, True), ds, spec, cfg).fit()
        log("  motif: train loss " + ", ".join(
            f"{e['train_loss']:.4f}" for e in history) + "; valid AUC "
            + ", ".join(f"{e['AUC']:.4f}" for e in history))
        if not history[-1]["train_loss"] < history[0]["train_loss"]:
            raise AssertionError("the motif train loss did not fall")

    def graphed_vs_eager(self):
        """8 steps of the flagship with dropout 0.25 at batch 256 on
        tie-free molecules, eager (scan_steps=1) and through the captured
        graph (scan_steps=8: 2 eager warm-up steps, capture, 6 replays), from
        the same weights, ids and generator seeds: losses within 1e-5
        relative, parameters within 1e-5. An unregistered dropout generator
        would replay one mask every step."""
        import numpy as np

        from molkgnn_torch.data.dataset import make_tie_free_dataset
        from molkgnn_torch.graphs.batch import spec_for_graphs
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        torch = self.torch
        ds = make_tie_free_dataset(2048 + 64, 2048, seed=SEED)
        spec = spec_for_graphs(ds.graphs, 256)
        trainers, losses = {}, {}
        for k in (1, 8):
            model = self.flagship(4, True, seed=SEED + 2, dropout=0.25)
            trainers[k] = Trainer(model, ds, spec, TrainConfig(
                batch_size=256, scan_steps=k, progress=False))
            losses[k] = torch.stack(trainers[k]._epoch_steps()).cpu().numpy()
        if trainers[8]._graph is None:
            raise AssertionError("scan_steps=8 captured no graph")
        rel = float(np.max(np.abs(losses[8] - losses[1]) / np.abs(losses[1])))
        sd = trainers[1].model.state_dict()
        diff = max((v - sd[k]).abs().max().item()
                   for k, v in trainers[8].model.state_dict().items())
        log(f"  graphed vs eager, 8 steps with dropout 0.25: losses "
            f"{[round(float(x), 6) for x in losses[8]]}; max relative loss "
            f"difference {rel:.3e}, max parameter difference {diff:.3e}")
        if len(set(losses[8].tolist())) != 8:
            raise AssertionError("graphed steps repeat a loss")
        if rel > 1e-5 or diff > 1e-5:
            raise AssertionError("graphed and eager steps differ by > 1e-5")
        self.graphed_vs_eager_record = {"max_rel_loss_diff": rel,
                                        "max_param_diff": diff}

    def epoch_rates(self, trainers, order, what):
        """Train graphs/s of each form over whole epochs of steps
        (``Trainer._epoch_steps``, as fit() runs them), each run
        synchronised once, forms in the given order; the scorer must launch
        ``launches_per_step`` times a step, replays included. trainers:
        {name: (trainer, launches_per_step)}."""
        import numpy as np

        from molkgnn_torch.ops import support_score as ss

        torch = self.torch
        for trainer, _ in trainers.values():  # warm: products, the capture
            trainer._epoch_steps()
        rates = {name: [] for name in trainers}
        for name in order:
            trainer, per_step = trainers[name]
            ss.grouped_support_score.launches = 0
            ss.support_score_backward.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = trainer._epoch_steps()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launched = ss.grouped_support_score.launches
            backward = ss.support_score_backward.launches
            if launched != per_step * len(losses) or backward != launched:
                raise AssertionError(
                    f"{what} {name}: {launched} scorer launches and "
                    f"{backward} of its backward for {len(losses)} steps, "
                    f"want {per_step} a step each")
            if not np.isfinite(torch.stack(losses).cpu().numpy()).all():
                raise AssertionError(f"{what} {name}: a loss is not finite")
            graphs = (len(losses) * trainer.config.batch_size
                      if trainer.config.device_sampling
                      else len(trainer._train_ids))
            rates[name].append(graphs / secs)
        card = self.torch.cuda.get_device_name(0)
        for name, r in rates.items():
            log(f"  {what} {name} on {card}: train "
                f"{', '.join(f'{x:.1f}' for x in r)} graphs/s (whole "
                f"epochs of steps, each synchronised once; scorer and "
                f"backward launches {trainers[name][1]} a step each, replays "
                f"counted)")
        return rates

    def replay_profile(self, trainer, what, n=16):
        """One block of ``n`` replays of a captured step: the device time by
        CUDA events, and from torch.profiler the device busy time over the
        wall time (idle share) and the top kernels."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        for _ in range(2):
            trainer._graph_step()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            trainer._graph_step()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        event_ms = start.elapsed_time(end)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                trainer._graph_step()
            torch.cuda.synchronize()
            prof_wall_ms = (time.perf_counter() - t0) * 1e3
        rows = device_rows(prof)
        busy = sum(r[0] for r in rows)
        log(f"  {what}, {n} replays: {event_ms:.3f} ms by CUDA events in "
            f"{wall_ms:.3f} ms wall ({event_ms / n:.3f} ms a step; "
            f"event time over wall {event_ms / wall_ms:.3f})")
        record = {"event_ms": event_ms, "wall_ms": wall_ms}
        if not rows:
            log("  profile of the replays: no device time recorded "
                "(not measured)")
            return record
        scorer = sum(r[0] for r in rows if KERNEL_NAME in r[2])
        log(f"  profile of the replays: device busy {busy:.3f} ms of "
            f"{prof_wall_ms:.3f} ms wall (idle share "
            f"{1 - busy / prof_wall_ms:.3f}, profiler on); scorer "
            f"{scorer:.3f} ms (share {scorer / busy:.3f})")
        for ms, count, key in sorted(rows, reverse=True)[:8]:
            log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")
        record.update(busy_ms=busy, profiled_wall_ms=prof_wall_ms,
                      idle_share=1 - busy / prof_wall_ms, scorer_ms=scorer)
        return record

    def graphed_throughput(self):
        """The flagship at batch 1024 with scan_steps=16, with and without
        device_sampling, beside the eager form: train graphs/s, launches,
        and the profile of a block of replays."""
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        ds, spec = self.train_data
        forms = {
            "eager": {},
            "graphed": {"scan_steps": 16},
            "graphed+device_sampling": {"scan_steps": 16,
                                        "device_sampling": True},
        }
        trainers = {
            name: (Trainer(self.flagship(4, True), ds, spec, TrainConfig(
                batch_size=BATCH, progress=False, **kw)), 4)
            for name, kw in forms.items()
        }
        names = list(forms)
        self.graphed_record = {"flagship_b1024": self.epoch_rates(
            trainers, names + names[::-1], "flagship b1024")}
        self.graphed_record["flagship_b1024_replays"] = self.replay_profile(
            trainers["graphed+device_sampling"][0],
            "flagship b1024 graphed+device_sampling")

    def phase_train(self, spec):
        self.grad_check(spec)
        self.kernel_vs_plain_training()
        self.graphed_vs_eager()
        with tempfile.TemporaryDirectory() as tmp:
            self.main_train_path(tmp)
            self.train_throughput()
            self.graphed_throughput()
            self.learning_check(tmp)

    # ------------------------------------------------------------ phase 6
    def phase_cli(self, tmp):
        """The port's CLI end to end on an AID-1798 SDF pair of mirror-image
        conformers (see ``write_enantiomer_sdfs``)."""
        import numpy as np

        from molkgnn_torch.cli import entry
        from molkgnn_torch.data.qsar import load_qsar_dataset
        from molkgnn_torch.tools.enantiomer import (
            ENANTIOMER_ARGS,
            JAX_CPU_RECORD,
            N_ACTIVE,
            SAMPLING_ARGS,
            parse_test_result,
            write_enantiomer_sdfs,
        )

        dataset_path = os.path.join(tmp, "dataset")
        root = os.path.join(dataset_path, "qsar", "clean_sdf")
        t0 = time.perf_counter()
        n_act, n_inact = N_ACTIVE, SMOKE_INACTIVES
        write_enantiomer_sdfs(os.path.join(root, "raw"), n_act, n_inact)
        log(f"  wrote {n_act} + {n_inact} SDF records in "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ds = load_qsar_dataset(root, "1798")
        ingest_s = time.perf_counter() - t0
        n_rec = n_act + n_inact
        log(f"  ingest + cache (load_qsar_dataset, host): {ingest_s:.1f} s "
            f"for {n_rec} records, {1e3 * ingest_s / n_rec:.3f} s per 1,000;"
            f" split sizes { {k: len(v) for k, v in ds.split.items()} }")
        cache = os.path.join(root, "processed", "kgnn-1798-3D-native.npz")
        if not os.path.exists(cache):
            raise AssertionError("the ingest cache was not written")
        self.cli_record = {"records": n_rec, "ingest_s": ingest_s}
        sizes = {k: len(v) for k, v in ds.split.items()}
        common = ["--dataset_name", "1798", "--dataset_path", dataset_path,
                  *SAMPLING_ARGS]

        def run(name, layers, epochs, extra):
            out = os.path.join(tmp, name)
            reset_launches()
            t0 = time.perf_counter()
            rc = entry.main(common + ["--default_root_dir", out,
                                      "--max_epochs", str(epochs), *extra])
            secs = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"{name}: the CLI returned {rc}")
            counts = launch_counts()
            launches = counts["grouped_support_score"]
            logs = os.path.join(out, "logs")
            tested = parse_test_result(os.path.join(logs, "test_result.log"))
            steps = epochs * -(-sizes["train"] // 32)
            eval_batches = (epochs * -(-sizes["valid"] // 32)
                            + (len(tested) + 1) * -(-sizes["test"] // 32))
            want = layers * (steps + eval_batches)
            log(f"  {name}: CLI in {secs:.1f} s; {steps} steps, "
                f"{eval_batches} evaluation batches (validation, "
                f"{len(tested)} checkpoints on test, the embeddings); "
                f"scorer launches {launches} (want {want}), fused "
                f"{counts['fused_support_score']}")
            if launches != want or counts["fused_support_score"]:
                raise AssertionError(f"{name}: scorer launches {counts}, "
                                     f"want {want} grouped and 0 fused")
            check_backward(counts, steps, name, per_step=layers)
            files = ["history.json", "test_result.log", "task_info.log",
                     "kernels/kernels.npz", "graph_embedding.npy"] + [
                f"test_sample_scores_{tag}.log" for tag in tested]
            missing = [f for f in files
                       if not os.path.exists(os.path.join(logs, f))]
            missing += [f"checkpoints/{tag}.pt" for tag in tested
                        if not os.path.exists(
                            os.path.join(out, "checkpoints", f"{tag}.pt"))]
            if missing:
                raise AssertionError(f"{name}: missing {missing}")
            with open(os.path.join(logs, "history.json")) as f:
                history = json.load(f)
            losses = [e["train_loss"] for e in history]
            if len(history) != epochs or not np.isfinite(losses).all():
                raise AssertionError(f"{name}: history {losses}")
            for tag, m in tested.items():
                if not all(np.isfinite(m[k]) for k in
                           ("AUC", "logAUC_0.001_0.1", "logAUC_0.001_1")):
                    raise AssertionError(f"{name} {tag}: metrics {m}")
            log(f"  {name}: train loss by epoch "
                f"{[round(x, 4) for x in losses]}; valid AUC "
                f"{[round(e['AUC'], 4) for e in history]}; test [last] "
                f"logAUC[0.001,0.1] {tested['last']['logAUC_0.001_0.1']:.4f}"
                f", AUC {tested['last']['AUC']:.4f}")
            return out, tested, losses, secs, counts

        def retest(name, out, tested):
            """--test on the run's root: the same tags, labels and, within
            1e-4, the same test predictions (test_sample_scores_{tag}.log,
            written as text) as the fit's; the metrics are reported. The
            sums run in a fixed order (ops/segment.py), so the restored
            checkpoints score as the fit's did; phase 14(b) holds the
            card's repeated runs bit for bit."""
            logs = os.path.join(out, "logs")

            def scores():
                return {tag: np.loadtxt(os.path.join(
                    logs, f"test_sample_scores_{tag}.log"), delimiter=",")
                    for tag in tested}

            before = scores()
            if entry.main(common + ["--default_root_dir", out,
                                    "--test"]) != 0:
                raise AssertionError(f"{name}: --test returned non-zero")
            again = parse_test_result(os.path.join(logs, "test_result.log"))
            after = scores()
            if again.keys() != tested.keys():
                raise AssertionError(f"{name}: --test tags {sorted(again)}")
            pred_gap = max(float(np.abs(after[t][:, 0] - b[:, 0]).max())
                           for t, b in before.items())
            labels_equal = all(np.array_equal(after[t][:, 1], b[:, 1])
                               for t, b in before.items())
            gap = max(abs(again[t][k] - v) for t, m in tested.items()
                      for k, v in m.items() if np.isfinite(v))
            log(f"  {name} --test on the same root: tags {sorted(again)}; "
                f"largest prediction difference {pred_gap:.3e}, largest "
                f"metric difference {gap:.3e} from the fit's logs")
            # Checked at the end of the phase, so that one run reports
            # every number of the phase.
            if not labels_equal or pred_gap > 1e-4:
                problems.append(f"{name}: --test predictions differ")
            return {"prediction_gap": pred_gap, "metric_gap": gap}

        problems = []

        out, tested, _, secs, counts = run("flagship", 4, 2, [])
        with open(os.path.join(out, "logs", "history.json")) as f:
            self.cli_history = json.load(f)
        self.cli_record["flagship"] = {
            "seconds": secs, "launches": counts, "test": tested,
            "retest": retest("flagship", out, tested)}
        self.cli_launches = counts
        self.cli_data = (ds, root)

        out, tested, losses, secs, counts = run(
            "enantiomer", 1, 20, ENANTIOMER_ARGS)
        common += ENANTIOMER_ARGS
        retested = retest("enantiomer", out, tested)
        if not losses[-1] < losses[0]:
            problems.append("the enantiomer train loss did not fall")
        self.cli_record["enantiomer"] = {
            "seconds": secs, "launches": counts, "test": tested,
            "train_loss": losses, "retest": retested,
            "jax_cpu_record": JAX_CPU_RECORD,
        }
        self.enantiomer_rates(ds)
        if problems:
            raise AssertionError("; ".join(problems))

    def enantiomer_rates(self, ds):
        """Train graphs/s of the enantiomer configuration at batch 32,
        eager against graph-replayed, on the phase's dataset."""
        from molkgnn_torch.graphs.batch import spec_for_graphs
        from molkgnn_torch.models.kgnn import MolKGNNNet
        from molkgnn_torch.training.model import GNNModel
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        spec = spec_for_graphs(ds.graphs, 32)

        def trainer(**kw):
            gen = self.torch.Generator().manual_seed(SEED)
            model = GNNModel(MolKGNNNet(num_layers=1, use_kernel=True,
                                        generator=gen),
                             ffn_dropout_rate=0.0, generator=gen)
            return Trainer(model, ds, spec, TrainConfig(
                batch_size=32, peak_lr=1e-2, progress=False, **kw)), 1

        trainers = {
            "eager": trainer(),
            "graphed+device_sampling": trainer(scan_steps=16,
                                               device_sampling=True),
        }
        names = list(trainers)
        self.graphed_record["enantiomer_b32"] = self.epoch_rates(
            trainers, names + names[::-1], "enantiomer b32")
        self.graphed_record["enantiomer_b32_replays"] = self.replay_profile(
            trainers["graphed+device_sampling"][0],
            "enantiomer b32 graphed+device_sampling")


    # ------------------------------------------------------------ phase 7
    def phase_screen(self, graphs, spec, tmp):
        self.screen_tie_free()
        self.screen_library_rates(graphs, spec)
        self.import_export_screen(tmp)
        self.evaluation_seconds()

    def screen_tie_free(self):
        """screen_library against predict_graphs on 2048 tie-free molecules
        at batch 512 over slabs of 1200 (two slabs): within 1e-4."""
        import numpy as np

        from molkgnn_torch.data.synthetic import tie_free_molgraph
        from molkgnn_torch.graphs.batch import spec_for_graphs
        from molkgnn_torch.serving.predictor import Predictor

        rng = np.random.default_rng(SEED + 7)
        mols = [tie_free_molgraph(rng) for _ in range(2048)]
        model = self.flagship(4, True, seed=3)
        pred = Predictor(model, model.state_dict(),
                         spec_for_graphs(mols, 512))
        want = pred.predict_graphs(mols)
        got = pred.screen_library(mols, slab=1200)
        diff = float(np.abs(got - want).max())
        log(f"  tie-free: screen_library over slabs "
            f"{[s['molecules'] for s in pred.screen_slabs]} against "
            f"predict_graphs: max |diff| {diff:.3e}")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def screen_library_rates(self, graphs, spec):
        """The main path of phase 7(a): the library screened, counted; then
        screening, predict_graphs end to end and forward only in turns."""
        import numpy as np

        from molkgnn_torch.graphs.batch import batch_graphs
        from molkgnn_torch.serving.predictor import Predictor

        torch = self.torch
        card = torch.cuda.get_device_name(0)
        library = list(graphs) * SCREEN_REPEAT
        n = len(library)
        blocks = sum(-(-min(SLAB, n - s) // BATCH) for s in range(0, n, SLAB))
        model = self.flagship(4, True)
        pred = Predictor(model, model.state_dict(), spec)
        reset_launches()
        t0 = time.perf_counter()
        scores = pred.screen_library(library, slab=SLAB)
        secs = time.perf_counter() - t0
        counts = launch_counts()
        launches = counts["grouped_support_score"]
        log(f"  screen_library: {n} molecules in {secs:.3f} s, {blocks} "
            f"blocks of {BATCH}; launches grouped {launches} (want "
            f"{4 * blocks}), fused {counts['fused_support_score']}")
        for i, slab in enumerate(pred.screen_slabs):
            log(f"    slab {i}: {slab['molecules']} molecules, host check "
                f"{slab['check_s']:.3f} s, flat packing and copy to the "
                f"card {slab['pack_s']:.3f} s")
        if launches != 4 * blocks or counts["fused_support_score"]:
            raise AssertionError("screen_library: scorer launches are not "
                                 "4 a block")
        if scores.shape != (n,) or not np.isfinite(scores).all():
            raise AssertionError("screen_library scores are not finite")
        want = pred.predict_graphs(graphs)
        gap = float(np.abs(scores[:len(graphs)] - want).max())
        repeat_gap = float(np.abs(scores.reshape(SCREEN_REPEAT, -1)
                                  - scores[:len(graphs)]).max())
        log(f"  screen_library against predict_graphs on the first "
            f"{len(graphs)}: max |diff| {gap:.3e}; across the "
            f"{SCREEN_REPEAT} copies {repeat_gap:.3e} (reported; phase "
            f"14(b) prints the gap on these molecules with ties)")
        self.screen_launches = counts
        check_backward(counts, 0, "screening")

        batches = [batch_graphs(graphs[s:s + BATCH], spec).to("cuda")
                   for s in range(0, len(graphs), BATCH)]

        def screen():
            pred.screen_library(library, slab=SLAB)

        def e2e():
            pred.predict_graphs(library)

        def forward_only():
            with torch.inference_mode():
                for _ in range(SCREEN_REPEAT):
                    for b in batches:
                        pred.model(b)
                torch.cuda.synchronize()

        forms = {"screen_library": screen, "predict_graphs": e2e,
                 "forward_only": forward_only}
        runs = {name: [] for name in forms}
        packs = []
        for name in ("screen_library", "predict_graphs", "forward_only",
                     "forward_only", "predict_graphs", "screen_library"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forms[name]()
            runs[name].append(time.perf_counter() - t0)
            if name == "screen_library":
                packs.append([s["pack_s"] for s in pred.screen_slabs])
        self.screen_record = {
            "molecules": n, "blocks": blocks, "launches": launches,
            "slabs": pred.screen_slabs, "pack_s_by_run": packs,
            "gap_to_predict_graphs": gap,
        }
        for name, secs in runs.items():
            self.screen_record[name] = {
                "seconds": secs, "graphs_per_s": n / min(secs)}
            log(f"  {name} on {card}: {n / min(secs):.1f} graphs/s (best of "
                f"{secs} s; {n} molecules at batch {BATCH})")
        log(f"  flat packing by slab in the timed screens: {packs} s")

    def import_export_screen(self, tmp):
        """Phase 7(b): a reference checkpoint through the import and screen
        CLIs on the card, against a Predictor with the same weights."""
        import numpy as np

        from molkgnn_torch.chem.features import mol_to_graph
        from molkgnn_torch.chem.sdf import parse_sdf
        from molkgnn_torch.cli import import_ckpt, screen
        from molkgnn_torch.serving.predictor import Predictor

        torch = self.torch
        _, root = self.cli_data
        raw = os.path.join(root, "raw")
        lib = os.path.join(tmp, "library.sdf")
        bad = 187  # the malformed record, between the two files' records
        with open(lib, "w") as f:
            for name in ("actives", "inactives"):
                with open(os.path.join(raw, f"1798_{name}_new.sdf")) as src:
                    f.write(src.read())
                if name == "actives":
                    f.write("garbage\n\n\n  0  0\nM  END\n$$$$\n")
        model = self.flagship(4, True, seed=SEED + 11)
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
        ref = dict(sd)
        h = model.gnn_model.graph_embedding_dim
        for key, shape in (("lin1.weight", (h, h)), ("lin1.bias", (h,)),
                           ("lin2.weight", (1, h)), ("lin2.bias", (1,)),
                           ("gnn_model.graph_embedding_linear.weight",
                            (h, 110)),
                           ("gnn_model.graph_embedding_linear.bias", (h,))):
            ref[key] = torch.randn(shape)
        for bn in ("node_batch_norm", "edge_batch_norm"):
            ref[f"gnn_model.{bn}.num_batches_tracked"] = torch.tensor(7)
        ckpt = os.path.join(tmp, "reference.ckpt")
        torch.save({"state_dict": ref, "epoch": 1}, ckpt)
        art = os.path.join(tmp, "model.pt2")
        csv = os.path.join(tmp, "scores.csv")

        t0 = time.perf_counter()
        if import_ckpt.main(["--torch_ckpt", ckpt, "--sdf", lib, "--out",
                             art, "--batch_size", str(BATCH)]) != 0:
            raise AssertionError("molkgnn-torch-import returned non-zero")
        import_s = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        if screen.main(["--exported", art, "--sdf", lib, "--out", csv]) != 0:
            raise AssertionError("molkgnn-torch-screen returned non-zero")
        screen_s = time.perf_counter() - t0
        counts = launch_counts()
        launches = counts["grouped_support_score"]
        got = np.array([
            np.nan if line.split(",")[1] == "" else float(line.split(",")[1])
            for line in open(csv).read().splitlines()[1:]
        ])
        graphs, invalid = [], []
        for i, (mol, _) in enumerate(parse_sdf(lib)):
            g = None if mol is None else mol_to_graph(mol, idx=i)
            if g is None:
                invalid.append(i)
            else:
                graphs.append(g)
        _, spec = Predictor.load_exported(art)
        want = Predictor(self.flagship(4, True), sd, spec).predict_graphs(
            graphs)
        batches = -(-len(graphs) // spec.num_graphs)
        nan_rows = np.nonzero(np.isnan(got))[0].tolist()
        diff = float(np.abs(got[~np.isnan(got)] - want).max())
        log(f"  import (exported on the card) {import_s:.1f} s; screen "
            f"{screen_s:.1f} s: {len(got)} records, empty rows {nan_rows}, "
            f"{len(graphs)} scored in {batches} batches, scorer launches "
            f"inside the exported program {launches} (want {4 * batches}); "
            f"max |CSV - Predictor| {diff:.3e}")
        if bad not in invalid or nan_rows != invalid:
            raise AssertionError(f"CSV rows: empty {nan_rows}, want the "
                                 f"records that do not parse {invalid}, "
                                 f"{bad} among them")
        if launches != 4 * batches or counts["fused_support_score"]:
            raise AssertionError("the exported program did not launch the "
                                 "scorer 4 times a batch")
        np.testing.assert_allclose(got[~np.isnan(got)], want, rtol=1e-4,
                                   atol=1e-4)
        self.export_launches = counts
        check_backward(counts, 0, "exported program")
        self.screen_record["cli"] = {
            "records": len(got), "import_s": import_s, "screen_s": screen_s,
            "launches": launches, "max_diff": diff}

    def evaluation_seconds(self):
        """Phase 7(c): evaluation at batch 32, the CLI's and alone."""
        import numpy as np

        from molkgnn_torch.graphs.batch import spec_for_graphs
        from molkgnn_torch.graphs.device_pack import gather_batch, pad_ids
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        torch = self.torch
        card = torch.cuda.get_device_name(0)
        ds, _ = self.cli_data
        valid_batches = -(-len(ds.split["valid"]) // 32)
        for e in self.cli_history:
            log(f"  CLI flagship epoch {e['epoch']}: evaluation "
                f"{e['eval_time_s']:.3f} s for {valid_batches} batches of 32 "
                f"({1e3 * e['eval_time_s'] / valid_batches:.2f} ms a batch);"
                f" eager before: {EAGER_EVAL_S} s for 194 batches "
                f"({1e3 * EAGER_EVAL_S / 194:.1f} ms a batch)")
        trainer = Trainer(self.flagship(4, True), ds,
                          spec_for_graphs(ds.graphs, 32),
                          TrainConfig(batch_size=32, progress=False))
        ids = np.arange(len(ds.graphs), dtype=np.int32)
        nb = -(-len(ids) // 32)
        idm = torch.as_tensor(np.stack(
            [pad_ids(ids[s:s + 32], 32) for s in range(0, len(ids), 32)]),
            device="cuda")

        def captured():
            return trainer._predict_ids(ids)[1]

        def eager():  # Trainer._predict_ids's loop before the block scorer
            trainer.model.eval()
            with torch.no_grad():
                preds = [trainer.model(gather_batch(
                    trainer._device_data, row, trainer.spec))[0]
                    for row in idm]
                return torch.cat(preds).cpu().numpy()[:len(ids)]

        reset_launches()
        first = captured()  # the capture
        counts = launch_counts()
        eval_launches = counts["grouped_support_score"]
        if eval_launches != 4 * nb or counts["fused_support_score"]:
            raise AssertionError(f"captured evaluation launched {counts}, "
                                 f"want {4 * nb} grouped and 0 fused")
        gap = float(np.abs(first - eager()).max())
        times = {"captured": [], "eager": []}
        for name in ("captured", "eager", "eager", "captured"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (captured if name == "captured" else eager)()
            times[name].append(time.perf_counter() - t0)
        for name, secs in times.items():
            log(f"  evaluation of {len(ids)} molecules ({nb} batches of 32),"
                f" flagship, {name} on {card}: {secs} s "
                f"({1e3 * min(secs) / nb:.3f} ms a batch)")
        log(f"  captured against eager: max |diff| {gap:.3e}; launches "
            f"{eval_launches} for {nb} batches (4 a batch, replays counted)")
        self.eval_launches = counts
        check_backward(counts, 0, "captured evaluation")
        self.eval_record = {
            "cli_eval_s": [e["eval_time_s"] for e in self.cli_history],
            "cli_valid_batches": valid_batches, "batches": nb,
            "seconds": times, "launches": eval_launches, "gap": gap}

    # ------------------------------------------------------------ phase 8
    def phase_points(self, graphs, tmp):
        """SchNet, DimeNet++ and SphereNet at their published widths, each
        through ingest, Trainer, Predictor, screening and the checks of
        the module doc; then the enantiomer configurations through the CLI.
        Every path counts the scorer's launches from 0: they must be 0."""
        t_phase = time.perf_counter()
        self.points_record, self.points_launches = {}, {}
        for name, n in POINT_MOLECULES.items():
            reset_launches()
            self.points_record[name] = self.point_family(name, graphs[:n],
                                                         tmp)
            self.points_launches[name] = launch_counts()
        reset_launches()
        self.points_record["quality"] = self.point_quality(tmp)
        self.points_launches["quality"] = launch_counts()
        log(f"  scorer launches on the point paths (each counted from 0): "
            f"{self.points_launches}")
        if any(v for c in self.points_launches.values()
               for v in scorer_launches(c).values()):
            raise AssertionError("a scorer kernel launched on a point path")
        secs = time.perf_counter() - t_phase
        self.points_record["seconds"] = secs
        log(f"  phase 8 took {secs:.1f} s")

    def family_model(self, name, dtype=None, **options):
        """GNNModel of the family at its published width (the encoder's
        defaults, with ``options``), random weights from the seed."""
        from molkgnn_torch.models.registry import get_family
        from molkgnn_torch.training.model import GNNModel

        gen = self.torch.Generator().manual_seed(SEED)
        model = GNNModel(get_family(name).make_encoder(generator=gen,
                                                       **options),
                         generator=gen)
        return model if dtype is None else model.to(dtype)

    def step_peak(self, model, data, spec, ids):
        """Peak device bytes of one forward and backward of the batch
        ``ids`` (None when the card runs out of memory)."""
        from molkgnn_torch.serving.predictor import device_pipeline
        from molkgnn_torch.training.model import bce_with_logits_loss

        gather_points = device_pipeline(spec)[1]

        torch = self.torch
        model.eval()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            batch = gather_points(data, ids, spec)
            pred, _ = model(batch)
            bce_with_logits_loss(pred, batch.y, batch.graph_mask).backward()
            torch.cuda.synchronize()
            return torch.cuda.max_memory_allocated()
        except torch.cuda.OutOfMemoryError:
            return None
        finally:
            batch = pred = None
            model.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()

    def point_family(self, name, mols, tmp):
        import dataclasses
        import gc

        import numpy as np

        from molkgnn_torch.data.dataset import QSAR_METRICS, Dataset, _split
        from molkgnn_torch.graphs.device_pack import pad_ids
        from molkgnn_torch.graphs.device_points import (
            DevicePointDataset,
            gather_points,
        )
        from molkgnn_torch.graphs.geometric import (
            batch_points,
            molecule_geometry,
        )
        from molkgnn_torch.models.registry import get_family
        from molkgnn_torch.serving.predictor import Predictor
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        torch = self.torch
        card = torch.cuda.get_device_name(0)
        family = get_family(name)
        rec = {"molecules": len(mols)}
        log(f"  {name}: {len(mols)} synthetic molecules (phase 3's), "
            "published width")

        # (a) ingest: host geometry, then packing and the copy to the card,
        # on copies of the molecules whose geometry cache is empty.
        fresh = [dataclasses.replace(g) for g in mols]
        geo = family.make_spec([], 1)  # the family's cutoff and levels
        t0 = time.perf_counter()
        levels = [molecule_geometry(g, geo.cutoff, geo.with_triplets,
                                    geo.with_torsion) for g in fresh]
        geo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = DevicePointDataset.from_graphs(fresh, geo, "cuda")
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        sizes = [int(sum(x[k].shape[1] for x in levels)) for k in range(3)]
        per_k = 1e3 / len(mols)
        mols = fresh  # their geometry is cached from here on
        rec["ingest"] = {"geometry_s": geo_s, "pack_s": pack_s,
                         "per_1000_s": (geo_s + pack_s) * per_k,
                         "edges": sizes[0], "triplets": sizes[1],
                         "quads": sizes[2]}
        log(f"    (a) ingest: geometry {geo_s:.3f} s + packing and copy "
            f"{pack_s:.3f} s = {(geo_s + pack_s) * per_k:.3f} s per 1,000 "
            f"molecules (host); {sizes[0]} edges, {sizes[1]} triplets, "
            f"{sizes[2]} quads in all")

        # The batch: the largest power of two <= 1024 (and <= the number
        # of molecules) whose train step on the heaviest molecules peaks
        # under POINT_MEMORY.
        model = self.family_model(name).cuda()
        heavy = np.argsort([-(x[2].shape[1] or x[1].shape[1] or x[0].shape[1])
                            for x in levels], kind="stable")
        probes = []
        for b in (1024, 512, 256, 128, 64, 32, 16, 8):
            if b > len(mols):
                continue
            spec = family.make_spec(fresh, b)
            ids = torch.as_tensor(heavy[:b].astype(np.int32), device="cuda")
            peak = self.step_peak(model, data, spec, ids)
            caps = {"nodes": spec.num_nodes, "edges": spec.num_edges,
                    "triplets": spec.num_triplets, "quads": spec.num_quads}
            probes.append({"batch": b, "caps": caps, "peak_bytes": peak})
            log(f"    batch {b}: caps {caps}; a train step on the heaviest "
                f"molecules peaks at "
                f"{'out of memory' if peak is None else f'{peak} bytes'}")
            if peak is not None and peak < POINT_MEMORY:
                break
        else:
            raise AssertionError(f"{name}: no batch fits")
        B = spec.num_graphs
        self.family_batches[name] = (mols, spec)  # for phase 14(c)
        rec.update(batch=B, caps=caps, peak_bytes=peak, probes=probes)
        log(f"    batch {B} (peak {peak / 2**30:.2f} GiB < "
            f"{POINT_MEMORY / 2**30:.0f} GiB)")
        del model
        gc.collect()

        # (b) training: 2 epochs with device sampling, eager against
        # replayed (scan_steps=16), from the same weights.
        ds = Dataset(name, mols, _split(np.random.default_rng(SEED + 1),
                                        len(mols)),
                     list(QSAR_METRICS), "bce_with_logits")
        train = {}
        for k in (1, 16):
            trainer = Trainer(self.family_model(name), ds, spec, TrainConfig(
                batch_size=B, max_epochs=2, scan_steps=k, oversample=True,
                device_sampling=True, progress=False,
                log_dir=os.path.join(tmp, f"points_{name}_{k}")),
                device="cuda")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            history = trainer.fit()
            fit_s = time.perf_counter() - t0
            steps = len(trainer.step_losses) // 2
            rates = [steps * B / (e["train_dispatch_time_s"]
                                  + e["train_readback_time_s"])
                     for e in history]
            train[k] = {"losses": trainer.step_losses, "graphs_per_s": rates,
                        "fit_s": fit_s,
                        "peak_bytes": torch.cuda.max_memory_allocated()}
            log(f"    (b) train {'eager' if k == 1 else 'replayed'} on "
                f"{card}: {', '.join(f'{r:.1f}' for r in rates)} graphs/s "
                f"by epoch ({steps} steps of {B} an epoch; fit with "
                f"evaluation {fit_s:.1f} s); first losses "
                f"{trainer.step_losses[:3]}")
            if not np.isfinite(trainer.step_losses).all():
                raise AssertionError(f"{name}: a train loss is not finite")
            if k > 1:
                train[k]["replays"] = self.replay_profile(
                    trainer, f"{name} b{B} replayed step", n=4)
            trainer = history = None
            gc.collect()
            torch.cuda.empty_cache()
        first = np.asarray(train[1]["losses"][:3])
        gap = float(np.abs(np.asarray(train[16]["losses"][:3]) - first).max()
                    / np.abs(first).max())
        log(f"    eager against replayed, first 3 losses: max relative "
            f"diff {gap:.3e} (limit 1e-5)")
        rec["train"] = {"eager": train[1], "replayed": train[16],
                        "first_losses_rel_diff": gap}
        if gap > 1e-5:
            raise AssertionError(f"{name}: replayed losses differ by {gap}")

        # (c) serving: predict_graphs end to end, forward only, and
        # screen_library over the molecules, ABCCBA.
        model = self.family_model(name)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        pred = Predictor(model, sd, spec, device="cuda")
        batches = [batch_points(mols[s:s + B], spec).to("cuda")
                   for s in range(0, len(mols), B)]
        runs = {"predict_graphs": [], "forward": [], "screen_library": []}
        outs = {}

        def forward():
            with torch.inference_mode():
                for b in batches:
                    pred.model(b)

        calls = {"predict_graphs": lambda: pred.predict_graphs(mols),
                 "forward": forward,
                 "screen_library": lambda: pred.screen_library(mols)}
        for what in ("predict_graphs", "forward", "screen_library",
                     "screen_library", "forward", "predict_graphs"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[what] = calls[what]()
            torch.cuda.synchronize()
            runs[what].append(len(mols) / (time.perf_counter() - t0))
        diff = float(np.abs(outs["screen_library"]
                            - outs["predict_graphs"]).max())
        scale = float(np.abs(outs["predict_graphs"]).max())
        for what, r in runs.items():
            log(f"    (c) {what} on {card}: "
                f"{', '.join(f'{x:.1f}' for x in r)} graphs/s")
        log(f"    screen_library against predict_graphs: max |diff| "
            f"{diff:.3e} (max |score| {scale:.3e})")
        rec["serve"] = {"graphs_per_s": runs, "screen_vs_predict": diff}
        if not np.isfinite(outs["screen_library"]).all() or (
                diff > 1e-4 * max(1.0, scale)):
            raise AssertionError(f"{name}: screening disagrees")
        batches = pred = outs = None

        # (d) the card against the CPU: fp64 within 1e-9, fp32 within 1e-4
        # of the fp64 values (relative to the largest).
        spec8 = family.make_spec(mols[:8], 8)
        b8 = batch_points(mols[:8], spec8)
        b64 = dataclasses.replace(b8, pos=b8.pos.double(), y=b8.y.double())
        m64 = self.family_model(name, torch.float64).eval()
        with torch.no_grad():
            want = m64(b64)[1].numpy()
            got64 = m64.cuda()(b64.to("cuda"))[1].cpu().numpy()
            got32 = self.family_model(name).cuda().eval()(
                b8.to("cuda"))[1].cpu().numpy()
        scale = max(1.0, float(np.abs(want).max()))
        d64 = float(np.abs(got64 - want).max()) / scale
        d32 = float(np.abs(got32 - want).max()) / scale
        log(f"    (d) 8 molecules, card against CPU: fp64 {d64:.3e}, fp32 "
            f"against fp64 {d32:.3e} (relative to max |value| {scale:.3e};"
            f" limits 1e-9, 1e-4)")
        rec["card_vs_cpu"] = {"fp64": d64, "fp32": d32}
        if d64 > 1e-9 or d32 > 1e-4:
            raise AssertionError(f"{name}: the card disagrees with the CPU")

        # (e) the device gather against the host packer, bit for bit.
        rng = np.random.default_rng(SEED)
        for ids in (np.arange(B), np.arange(len(mols) - B // 2, len(mols)),
                    rng.choice(len(mols), B, replace=False)):
            ids = ids.astype(np.int32)
            got = gather_points(data, torch.as_tensor(
                pad_ids(ids, B), device="cuda"), spec)
            want = batch_points([mols[i] for i in ids], spec)
            for a, b in zip(got.leaves(), want.leaves()):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"{name}: gather_points differs")
        log("    (e) gather_points on the card equals batch_points bit for "
            "bit (3 id sets, one padded)")

        # (f) the mirror contract on the card.
        model = self.family_model(name).cuda().eval()
        batch = batch_points(mols[:B], spec).to("cuda")
        flip = torch.tensor([-1.0, 1.0, 1.0], device="cuda")
        with torch.no_grad():
            a = model(batch)[1]
            b = model(dataclasses.replace(batch, pos=batch.pos * flip))[1]
        mirror = float((a - b).abs().max() / a.abs().max())
        rec["mirror_rel_diff"] = mirror
        if name == "spherenet":
            ok = float((a - b).abs().max()) > 1e-6
            want_txt = "> 1e-6 absolute: the torsion sees the mirror"
        else:
            ok = mirror <= 1e-5
            want_txt = ("<= 1e-5 relative: invariant up to the "
                        "rounding of the mirrored geometry")
        log(f"    (f) mirror image on the card: max relative diff "
            f"{mirror:.3e} (want {want_txt})")
        if not ok:
            raise AssertionError(f"{name}: the mirror contract fails")
        del batch, model, data
        gc.collect()
        torch.cuda.empty_cache()
        if name == POINT_EXPORT:
            rec["export"] = self.family_export(name, tmp)
        return rec

    def family_export(self, name, tmp):
        """(h) A reference-layout .ckpt of the family through the import CLI
        (exported on the card) and the screen CLI on an SDF library: the
        CSV against a Predictor with the same weights; a record the family
        cannot featurize (for ChIRoNet, no dihedral) has an empty cell."""
        import numpy as np

        from molkgnn_torch.chem.sdf import parse_sdf
        from molkgnn_torch.cli import import_ckpt, screen
        from molkgnn_torch.models.registry import get_family
        from molkgnn_torch.serving.predictor import (
            Predictor,
            host_pipeline_for_spec,
        )
        from molkgnn_torch.tools.enantiomer import write_enantiomer_sdfs

        torch = self.torch
        family = get_family(name)
        to_graph = host_pipeline_for_spec(family.make_spec([], 1))[0]
        lib_dir = os.path.join(tmp, f"export_{name}_lib")
        write_enantiomer_sdfs(lib_dir, 32, 96)
        sdf = os.path.join(lib_dir, "1798_inactives_new.sdf")
        model = self.family_model(name)
        ckpt = os.path.join(lib_dir, "ref.ckpt")
        torch.save({"state_dict": {"model." + k: v for k, v in
                                   model.state_dict().items()}}, ckpt)
        art = os.path.join(lib_dir, f"{name}.pt2")
        csv = os.path.join(lib_dir, "scores.csv")
        rc = import_ckpt.main(["--torch_ckpt", ckpt, "--sdf", sdf, "--out",
                               art, "--batch_size", "32", "--prefix",
                               "model.", "--gnn_type", name,
                               "--device", "cuda"])
        rc = rc or screen.main(["--exported", art, "--sdf", sdf, "--out",
                                csv, "--device", "cuda"])
        if rc:
            raise AssertionError(f"{name}: the import or screen CLI failed")
        with open(csv) as f:
            cells = [line.split(",")[1] for line in f.read().splitlines()[1:]]
        graphs = [to_graph(m, y=0.0, idx=i)
                  for i, (m, _) in enumerate(parse_sdf(sdf))]
        empty = [i for i, g in enumerate(graphs) if g is None]
        graphs = [g for g in graphs if g is not None]
        got = np.array([float(c) for c in cells if c])
        spec = family.make_spec(graphs, 32)
        want = Predictor(model, model.state_dict(), spec,
                         device="cuda").predict_graphs(graphs)
        diff = float(np.abs(got - want).max())
        log(f"    (h) {name}: import CLI -> exported program -> screen CLI "
            f"on {len(cells)} SDF records ({len(empty)} not featurizable, "
            f"empty cells): CSV against the Predictor max |diff| "
            f"{diff:.3e} (limit 1e-4)")
        if (got.shape != want.shape or diff > 1e-4
                or [i for i, c in enumerate(cells) if not c] != empty):
            raise AssertionError(f"{name}: the exported CSV disagrees")
        return {"records": len(cells), "empty": len(empty),
                "csv_vs_predictor": diff}

    def point_quality(self, tmp):
        """(i) The enantiomer configurations of the point families through
        the CLI on phase 6's SDF pair (6,000 inactives, its ingest cache),
        beside the JAX-CPU records (printed, not asserted)."""
        from molkgnn_torch.tools import enantiomer

        out = {}
        for name in POINT_MOLECULES:
            r = enantiomer.cli_run(os.path.join(tmp, "dataset"),
                                   os.path.join(tmp, f"enantiomer_{name}"),
                                   gnn_type=name, device="cuda")
            last, rec = r["test"]["last"], r["jax_cpu_record"]
            out[name] = {"epochs": r["epochs"], "test_last": last,
                         "train_loss": r["train_loss"],
                         "jax_cpu_record": rec, "cli_s": r["cli_s"]}
            log(f"  (i) enantiomer {name}, {r['epochs']} epochs, "
                f"{enantiomer.N_ACTIVE + SMOKE_INACTIVES} records: test "
                f"[last] logAUC[0.001,0.1] "
                f"{last['logAUC_0.001_0.1']:.4f}, AUC {last['AUC']:.4f} "
                f"(JAX-CPU at 61,645 inactives {rec['logAUC_0.001_0.1']:.4f}"
                f" / {rec['AUC']:.4f}); CLI {r['cli_s']:.1f} s")
        return out

    # ------------------------------------------------------------ phase 9
    def phase_chiro(self, tmp):
        """ChIRoNet at its published widths through ingest, Trainer,
        Predictor, screening, the import and screen CLIs and the enantiomer
        CLI run, with the checks of the module doc. Every path counts the
        scorer's launches from 0: they must be 0."""
        t_phase = time.perf_counter()
        self.chiro_record, self.chiro_launches = {}, {}
        export = functools.partial(self.family_export, "chironet")
        for path, run in (("family", self.chiro_family),
                          ("export", export),
                          ("quality", self.chiro_quality)):
            reset_launches()
            self.chiro_record[path] = run(tmp)
            self.chiro_launches[path] = launch_counts()
        log(f"  (g) scorer launches on the ChIRoNet paths (each counted "
            f"from 0): {self.chiro_launches}")
        if any(v for c in self.chiro_launches.values()
               for v in scorer_launches(c).values()):
            raise AssertionError("a scorer kernel launched on a ChIRoNet "
                                 "path")
        secs = time.perf_counter() - t_phase
        self.chiro_record["seconds"] = secs
        log(f"  phase 9 took {secs:.1f} s")

    def chiro_molecules(self):
        """(the scaffold set's ChiroGraphs, featurisation seconds): each
        SMILES embedded under CHIRO_SEEDS seeds, actives labelled 1."""
        from molkgnn_torch.chem.embed import embed_molecule
        from molkgnn_torch.chem.smiles import parse_smiles
        from molkgnn_torch.graphs.chiro import mol_to_chiro_graph

        mols = []
        for seed in range(CHIRO_SEEDS):
            for label, pool in ((1.0, ACTIVE_SMILES), (0.0, INACTIVE_SMILES)):
                for smi in pool:
                    mol = parse_smiles(smi, add_hs=True)
                    pos = embed_molecule(mol, seed=seed, iterations=60)
                    for a, p in zip(mol.atoms, pos):
                        a.x, a.y, a.z = map(float, p)
                    mols.append((mol, label, smi))
        t0 = time.perf_counter()
        graphs = [mol_to_chiro_graph(m, y=y, idx=i, smiles=smi)
                  for i, (m, y, smi) in enumerate(mols)]
        feat_s = time.perf_counter() - t0
        if any(g is None for g in graphs):
            raise AssertionError("a scaffold molecule has no dihedral")
        return graphs, feat_s

    def chiro_family(self, tmp):
        import dataclasses
        import gc

        import numpy as np

        from molkgnn_torch.data.dataset import QSAR_METRICS, Dataset, _split
        from molkgnn_torch.graphs.chiro import batch_chiro
        from molkgnn_torch.graphs.device_chiro import (
            DeviceChiroDataset,
            gather_chiro,
        )
        from molkgnn_torch.graphs.device_pack import pad_ids
        from molkgnn_torch.models.registry import get_family
        from molkgnn_torch.serving.predictor import Predictor
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        torch = self.torch
        card = torch.cuda.get_device_name(0)
        name = "chironet"
        family = get_family(name)
        conformers, feat_s = self.chiro_molecules()
        mols = [dataclasses.replace(conformers[i % len(conformers)], idx=i)
                for i in range(NUM_MOLECULES)]
        rec = {"molecules": len(mols), "conformers": len(conformers)}
        log(f"  chironet: {len(conformers)} conformers of the 29 scaffold "
            f"SMILES repeated to {len(mols)} molecules, published width")

        # (a) ingest: host featurisation, then packing and the copy to the
        # card.
        t0 = time.perf_counter()
        data = DeviceChiroDataset.from_graphs(mols, "cuda")
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        counts = np.asarray([g.counts() for g in mols], np.int64)
        feat_k = 1e3 * feat_s / len(conformers)
        pack_k = 1e3 * pack_s / len(mols)
        rec["ingest"] = {"featurize_s_per_1000": feat_k,
                         "pack_s_per_1000": pack_k,
                         "totals": counts.sum(axis=0).tolist()}
        log(f"    (a) ingest: mol_to_chiro_graph {feat_k:.3f} s per 1,000 "
            f"molecules ({len(conformers)} timed), packing and copy "
            f"{pack_k:.4f} s per 1,000 (host); totals (nodes, edges, "
            f"distances, angles, dihedrals, alpha) "
            f"{counts.sum(axis=0).tolist()}")

        # The batch, as in phase 8, on the molecules with the most edges
        # (the EConv's per-edge weight matrices dominate).
        model = self.family_model(name).cuda()
        heavy = np.argsort(-counts[:, 1], kind="stable")
        probes = []
        for b in (1024, 512, 256, 128, 64, 32, 16, 8):
            if b > len(mols):
                continue
            spec = family.make_spec(mols, b)
            ids = torch.as_tensor(heavy[:b].astype(np.int32), device="cuda")
            peak = self.step_peak(model, data, spec, ids)
            caps = dict(zip(("nodes", "edges", "distances", "angles",
                             "dihedrals", "alpha"), spec.capacities()))
            probes.append({"batch": b, "caps": caps, "peak_bytes": peak})
            log(f"    batch {b}: caps {caps}; a train step on the heaviest "
                f"molecules peaks at "
                f"{'out of memory' if peak is None else f'{peak} bytes'}")
            if peak is not None and peak < POINT_MEMORY:
                break
        else:
            raise AssertionError(f"{name}: no batch fits")
        B = spec.num_graphs
        self.family_batches[name] = (mols, spec)  # for phase 14(c)
        rec.update(batch=B, caps=caps, peak_bytes=peak, probes=probes)
        log(f"    batch {B} (peak {peak / 2**30:.2f} GiB < "
            f"{POINT_MEMORY / 2**30:.0f} GiB)")
        del model
        gc.collect()

        # (b) training: 2 epochs with device sampling, eager against
        # replayed (scan_steps=16), from the same weights.
        ds = Dataset(name, mols, _split(np.random.default_rng(SEED + 1),
                                        len(mols)),
                     list(QSAR_METRICS), "bce_with_logits")
        train = {}
        for k in (1, 16):
            trainer = Trainer(self.family_model(name), ds, spec, TrainConfig(
                batch_size=B, max_epochs=2, scan_steps=k, oversample=True,
                device_sampling=True, progress=False,
                log_dir=os.path.join(tmp, f"chiro_{k}")), device="cuda")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            history = trainer.fit()
            fit_s = time.perf_counter() - t0
            steps = len(trainer.step_losses) // 2
            rates = [steps * B / (e["train_dispatch_time_s"]
                                  + e["train_readback_time_s"])
                     for e in history]
            train[k] = {"losses": trainer.step_losses, "graphs_per_s": rates,
                        "fit_s": fit_s,
                        "peak_bytes": torch.cuda.max_memory_allocated()}
            log(f"    (b) train {'eager' if k == 1 else 'replayed'} on "
                f"{card}: {', '.join(f'{r:.1f}' for r in rates)} graphs/s "
                f"by epoch ({steps} steps of {B} an epoch; fit with "
                f"evaluation {fit_s:.1f} s); first losses "
                f"{trainer.step_losses[:3]}")
            if not np.isfinite(trainer.step_losses).all():
                raise AssertionError(f"{name}: a train loss is not finite")
            if k > 1:
                train[k]["replays"] = self.replay_profile(
                    trainer, f"{name} b{B} replayed step", n=4)
            trainer = history = None
            gc.collect()
            torch.cuda.empty_cache()
        first = np.asarray(train[1]["losses"][:3])
        gap = float(np.abs(np.asarray(train[16]["losses"][:3]) - first).max()
                    / np.abs(first).max())
        log(f"    eager against replayed, first 3 losses: max relative "
            f"diff {gap:.3e} (limit 1e-5)")
        rec["train"] = {"eager": train[1], "replayed": train[16],
                        "first_losses_rel_diff": gap}
        if gap > 1e-5:
            raise AssertionError(f"{name}: replayed losses differ by {gap}")

        # (c) serving: predict_graphs end to end, forward only, and
        # screen_library over the molecules, ABCCBA.
        model = self.family_model(name)
        pred = Predictor(model, model.state_dict(), spec, device="cuda")
        batches = [batch_chiro(mols[s:s + B], spec).to("cuda")
                   for s in range(0, len(mols), B)]
        runs = {"predict_graphs": [], "forward": [], "screen_library": []}
        outs = {}

        def forward():
            with torch.inference_mode():
                for b in batches:
                    pred.model(b)

        calls = {"predict_graphs": lambda: pred.predict_graphs(mols),
                 "forward": forward,
                 "screen_library": lambda: pred.screen_library(mols)}
        for what in ("predict_graphs", "forward", "screen_library",
                     "screen_library", "forward", "predict_graphs"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[what] = calls[what]()
            torch.cuda.synchronize()
            runs[what].append(len(mols) / (time.perf_counter() - t0))
        diff = float(np.abs(outs["screen_library"]
                            - outs["predict_graphs"]).max())
        scale = float(np.abs(outs["predict_graphs"]).max())
        for what, r in runs.items():
            log(f"    (c) {what} on {card}: "
                f"{', '.join(f'{x:.1f}' for x in r)} graphs/s")
        log(f"    screen_library against predict_graphs: max |diff| "
            f"{diff:.3e} (max |score| {scale:.3e})")
        rec["serve"] = {"graphs_per_s": runs, "screen_vs_predict": diff,
                        "screen_slabs": pred.screen_slabs}
        if not np.isfinite(outs["screen_library"]).all() or (
                diff > 1e-4 * max(1.0, scale)):
            raise AssertionError(f"{name}: screening disagrees")
        batches = pred = outs = None

        # (d) the card against the CPU: fp64 within 1e-9, fp32 within 1e-4
        # of the fp64 values (relative to the largest), for the default
        # model and one with chiral message passing and softmax c.
        eight = [conformers[i * 29 // 8] for i in range(8)]
        b8 = batch_chiro(eight, family.make_spec(eight, 8))
        b64 = dataclasses.replace(b8, **{
            f: getattr(b8, f).double()
            for f in ("x", "edge_attr", "distances", "angles", "dihedrals",
                      "y")})
        rec["card_vs_cpu"] = {}
        for label, options in (("default", {}), ("cmp_softmax", CHIRO_CMP)):
            m64 = self.family_model(name, torch.float64, **options).eval()
            with torch.no_grad():
                want = m64(b64)[1].numpy()
                got64 = m64.cuda()(b64.to("cuda"))[1].cpu().numpy()
                got32 = self.family_model(name, **options).cuda().eval()(
                    b8.to("cuda"))[1].cpu().numpy()
            scale = max(1.0, float(np.abs(want).max()))
            d64 = float(np.abs(got64 - want).max()) / scale
            d32 = float(np.abs(got32 - want).max()) / scale
            log(f"    (d) {label}, 8 molecules, card against CPU: fp64 "
                f"{d64:.3e}, fp32 against fp64 {d32:.3e} (relative to max "
                f"|value| {scale:.3e}; limits 1e-9, 1e-4)")
            rec["card_vs_cpu"][label] = {"fp64": d64, "fp32": d32}
            if d64 > 1e-9 or d32 > 1e-4:
                raise AssertionError(f"{name} {label}: the card disagrees "
                                     "with the CPU")

        # (e) the device gather against the host packer, bit for bit.
        rng = np.random.default_rng(SEED)
        for ids in (np.arange(B), np.arange(len(mols) - B // 2, len(mols)),
                    rng.choice(len(mols), B, replace=False)):
            ids = ids.astype(np.int32)
            got = gather_chiro(data, torch.as_tensor(
                pad_ids(ids, B), device="cuda"), spec)
            want = batch_chiro([mols[i] for i in ids], spec)
            for a, b in zip(got.leaves(), want.leaves()):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"{name}: gather_chiro differs")
        log("    (e) gather_chiro on the card equals batch_chiro bit for "
            "bit (3 id sets, one padded)")
        del data
        rec["mirror"] = self.chiro_mirror(tmp)
        gc.collect()
        torch.cuda.empty_cache()
        return rec

    def chiro_mirror(self, tmp):
        """(f) Phase 6's mirror pairs (record i of the actives and of the
        inactives): every R/S tag flips, and the model's outputs move."""
        import itertools

        import numpy as np

        from molkgnn_torch.chem.sdf import parse_sdf
        from molkgnn_torch.graphs.chiro import (
            batch_chiro,
            chiro_spec_for_graphs,
            mol_to_chiro_graph,
        )
        from molkgnn_torch.tools.enantiomer import N_ACTIVE

        torch = self.torch
        raw = os.path.join(tmp, "dataset", "qsar", "clean_sdf", "raw")
        sides = [[mol_to_chiro_graph(m) for m, _ in itertools.islice(
            parse_sdf(os.path.join(raw, f"1798_{kind}_new.sdf")), N_ACTIVE)]
            for kind in ("actives", "inactives")]
        pairs = [(a, b) for a, b in zip(*sides) if a is not None]
        if any(b is None for _, b in pairs):
            raise AssertionError("a mirror image lost its dihedrals")
        flipped = all(
            np.array_equal(b.x[:, -8:-6], a.x[:, -8:-6][:, ::-1])
            and a.x[:, -8:-6].any() for a, b in pairs)
        plus, minus = zip(*pairs)
        spec = chiro_spec_for_graphs(list(plus), len(pairs))
        model = self.family_model("chironet").cuda().eval()
        with torch.no_grad():
            a = model(batch_chiro(plus, spec).to("cuda"))[1]
            b = model(batch_chiro(minus, spec).to("cuda"))[1]
        diff = float((a - b).abs().max())
        rel = diff / float(a.abs().max())
        log(f"    (f) {len(pairs)} mirror pairs of phase 6 "
            f"({N_ACTIVE - len(pairs)} without a dihedral): R/S tags "
            f"flipped in every pair {flipped}; outputs max |diff| {diff:.3e} (relative {rel:.3e};"
            f" want > 1e-6: not invariant)")
        if not flipped or diff <= 1e-6:
            raise AssertionError("chironet: the mirror contract fails")
        return {"pairs": len(pairs), "tags_flipped": flipped,
                "max_abs_diff": diff, "rel_diff": rel}

    def chiro_quality(self, tmp):
        """(i) The enantiomer ChIRoNet configuration through the CLI on
        phase 6's SDF pair (6,000 inactives; the ChIRoNet ingest and its
        cache run inside the CLI), beside the JAX-CPU record (printed, not
        asserted)."""
        from molkgnn_torch.tools import enantiomer

        r = enantiomer.cli_run(os.path.join(tmp, "dataset"),
                               os.path.join(tmp, "enantiomer_chironet"),
                               gnn_type="chironet", device="cuda")
        last, rec = r["test"]["last"], r["jax_cpu_record"]
        log(f"  (i) enantiomer chironet, {r['epochs']} epochs, "
            f"{enantiomer.N_ACTIVE + SMOKE_INACTIVES} records: test [last] "
            f"logAUC[0.001,0.1] {last['logAUC_0.001_0.1']:.4f}, AUC "
            f"{last['AUC']:.4f} (JAX-CPU at 61,645 inactives "
            f"{rec['logAUC_0.001_0.1']:.4f} / {rec['AUC']:.4f}); CLI "
            f"{r['cli_s']:.1f} s")
        return {"epochs": r["epochs"], "test_last": last,
                "train_loss": r["train_loss"], "jax_cpu_record": rec,
                "cli_s": r["cli_s"]}

    # ------------------------------------------------------------ phase 10
    def phase_side(self, tmp):
        """Balanced batches, fixed kernel sets with score capture, the CLI's
        --balanced_batches, the profiler region and a sweep (see the
        module doc). Each main path counts the scorer's launches from 0."""
        t_phase = time.perf_counter()
        self.side_record, self.side_launches = {}, {}
        self.balanced_batches(tmp)
        self.fixed_kernel_sets(tmp)
        self.balanced_cli(tmp)
        self.monitors_and_sweep(tmp)
        secs = time.perf_counter() - t_phase
        self.side_record["seconds"] = secs
        log(f"  phase 10 took {secs:.1f} s")

    def balanced_batches(self, tmp):
        """(a) of phase 10, on phase 5's 8192 molecules at batch 1024."""
        import numpy as np

        from molkgnn_torch.data.dataset import (
            make_tie_free_dataset,
            oversampling_weights,
        )
        from molkgnn_torch.graphs.balance import (
            FIELD_NAMES,
            SIZE_FIELD,
            batch_field_sums,
            caps_vector,
            count_matrix,
            deal_by_size,
            spec_for_dataset,
        )
        from molkgnn_torch.graphs.batch import spec_for_graphs
        from molkgnn_torch.graphs.device_pack import pad_ids
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        torch = self.torch
        ds, cover = self.train_data
        t0 = time.perf_counter()
        tight = spec_for_dataset(ds, BATCH)
        spec_s = time.perf_counter() - t0
        counts = count_matrix(ds.graphs)
        # One oversampled draw of the train split, dealt (tight spec) and
        # taken in draw order (cover spec): mean occupancy of each padded
        # field over the epoch's batches, the last (partial) one included.
        train = np.asarray(ds.split["train"])
        w = oversampling_weights(np.array([ds.graphs[i].y for i in train]))
        draw = train[np.random.default_rng(SEED).choice(
            len(train), size=len(train), p=w / w.sum())]
        dealt, _ = deal_by_size(draw, counts[draw, SIZE_FIELD], BATCH)
        seq = np.stack([pad_ids(draw[s:s + BATCH], BATCH)
                        for s in range(0, len(draw), BATCH)])
        occupancy = {
            "balanced": (batch_field_sums(dealt, counts)
                         / caps_vector(tight)).mean(0).tolist(),
            "cover": (batch_field_sums(seq, counts)
                      / caps_vector(cover)).mean(0).tolist(),
        }
        caps = {"balanced": caps_vector(tight).tolist(),
                "cover": caps_vector(cover).tolist()}
        log(f"  spec_for_dataset({len(ds.graphs)} molecules, batch {BATCH})"
            f" in {spec_s:.2f} s (host)")
        for name in ("balanced", "cover"):
            log(f"    {name}: capacities " + ", ".join(
                f"{f} {c}" for f, c in zip(FIELD_NAMES, caps[name]))
                + "; mean occupancy " + ", ".join(
                f"{f} {o:.3f}" for f, o in zip(FIELD_NAMES, occupancy[name])))
        record = {"spec_s": spec_s, "capacities": caps,
                  "occupancy": occupancy}

        def trainer(spec, data=ds, **kw):
            return Trainer(self.flagship(4, True), data, spec, TrainConfig(
                batch_size=BATCH, max_epochs=2, progress=False,
                log_dir=os.path.join(tmp, "balanced"), **kw))

        def first3(a, b):
            a, b = np.array(a[:3]), np.array(b[:3])
            return float(np.max(np.abs(a - b) / np.abs(b)))

        # The replayed fit is the phase's main path, counted. Two eager fits
        # from the same weights and seeds stand beside it, reported: on
        # these molecules (neighbours with bitwise-equal features) the
        # argmax follows any last-bit change; the sums now run in a fixed
        # order and phase 14(b) holds eager against replayed on them. The
        # 1e-5 comparison is held on tie-free molecules below.
        replayed = trainer(tight, balanced_batches=True, scan_steps=16)
        reset_launches()
        t0 = time.perf_counter()
        history = replayed.fit()
        fit_s = time.perf_counter() - t0
        launches = launch_counts()
        self.side_launches["balanced"] = launches
        if replayed._graph is None:
            raise AssertionError("balanced scan_steps=16 captured no graph")
        eval_batches = 2 * -(-len(ds.split["valid"]) // BATCH)
        want = 4 * (replayed.step + eval_batches)
        eager = [trainer(tight, balanced_batches=True) for _ in range(2)]
        for t in eager:
            t.fit()
        got = replayed.step_losses
        rel = first3(got, eager[0].step_losses)
        rel_eager = first3(eager[1].step_losses, eager[0].step_losses)
        log(f"  balanced fit, 2 epochs replayed (scan_steps=16) in "
            f"{fit_s:.2f} s: {replayed.step} steps, {eval_batches} "
            f"evaluation batches, launches {launches} (want {want} grouped,"
            f" 0 fused); valid AUC {[round(e['AUC'], 4) for e in history]};"
            f" first 3 losses {got[:3]}, max relative difference from an "
            f"eager run {rel:.3e}, between two eager runs {rel_eager:.3e} "
            f"(phase 3's molecules: argmax ties, reported; phase 14(b) "
            f"holds them)")
        if scorer_launches(launches) != {"grouped_support_score": want,
                        "fused_support_score": 0}:
            raise AssertionError(f"balanced launches {launches}, want {want}")
        check_backward(launches, replayed.step, "balanced fit")
        if not all(np.isfinite(t.step_losses).all()
                   for t in (replayed, *eager)):
            raise AssertionError("a balanced loss is not finite")
        tf = make_tie_free_dataset(NUM_MOLECULES, NUM_MOLECULES * 3 // 4,
                                   seed=SEED)
        tf_tight = spec_for_dataset(tf, BATCH)
        runs = [trainer(tf_tight, tf, balanced_batches=True, **kw)
                for kw in ({}, {"scan_steps": 16})]
        for t in runs:
            t.fit()
        rel_tf = first3(runs[1].step_losses, runs[0].step_losses)
        log(f"  {NUM_MOLECULES} tie-free molecules, balanced, 2 epochs: "
            f"replayed first 3 losses {runs[1].step_losses[:3]} against "
            f"eager {runs[0].step_losses[:3]}: max relative difference "
            f"{rel_tf:.3e}")
        if rel_tf > 1e-5 or runs[1]._graph is None:
            raise AssertionError("balanced replayed and eager losses differ")
        record.update(fit_s=fit_s, launches=launches, eval_batches=eval_batches,
                      steps=replayed.step, max_rel_loss_diff=rel,
                      max_rel_loss_diff_eager=rel_eager,
                      tie_free_max_rel_loss_diff=rel_tf)

        # Train graphs/s and device memory of the replayed form, balanced
        # against cover: each trainer is built and runs its first epoch
        # (eager warm-up steps, the capture, replays) in a window whose
        # peak is read above what was allocated before it (its dataset,
        # weights, optimizer, the step and the graph's pool); then whole
        # epochs, ABBA.
        forms, peaks = {}, {}
        for name, spec, kw in (("balanced", tight,
                                {"balanced_batches": True}),
                               ("cover", cover, {})):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            forms[name] = trainer(spec, scan_steps=16, **kw)
            forms[name]._epoch_steps()
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - base
        rates = {name: [] for name in forms}
        for name in ("balanced", "cover", "cover", "balanced"):
            t = forms[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t._epoch_steps()
            torch.cuda.synchronize()
            rates[name].append(len(train) / (time.perf_counter() - t0))
        # One eager step's working memory: each spec's first batch of the
        # draw, bytes above what was allocated before the step.
        work = {}
        for name, spec, ids in (("balanced", tight, dealt[0]),
                                ("cover", cover, seq[0])):
            t = trainer(spec)
            t._step_ids(ids)  # warm
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t._step_ids(ids)
            torch.cuda.synchronize()
            work[name] = torch.cuda.max_memory_allocated() - base
            del t
        card = torch.cuda.get_device_name(0)
        for name in forms:
            log(f"  {name} replayed on {card}: train "
                f"{', '.join(f'{r:.1f}' for r in rates[name])} graphs/s "
                f"(whole epochs, ABBA); peak {peaks[name] / 2**30:.3f} GiB "
                f"above the baseline over the trainer's build and first "
                f"epoch; one eager step's working memory "
                f"{work[name] / 2**30:.3f} GiB")
        record.update(graphs_per_s=rates, peak_bytes=peaks,
                      step_work_bytes=work)

        # Evaluation: balanced (dealt, tight spec) against cover
        # (consecutive, cover spec), the same weights, tie-free molecules.
        ids = np.concatenate([tf.split["valid"], tf.split["test"]])
        preds = {}
        for name, spec, balanced in (
                ("balanced", tf_tight, True),
                ("cover", spec_for_graphs(tf.graphs, BATCH), False)):
            t = Trainer(self.flagship(4, True), tf, spec, TrainConfig(
                batch_size=BATCH, progress=False, balanced_batches=balanced))
            preds[name] = t._predict_ids(ids)
        if not np.array_equal(preds["balanced"][0], preds["cover"][0]):
            raise AssertionError("balanced evaluation labels out of order")
        gap = float(np.abs(preds["balanced"][1] - preds["cover"][1]).max())
        log(f"  evaluation of {len(ids)} tie-free molecules, balanced "
            f"against cover, same weights: max |difference| {gap:.3e}")
        if gap > 1e-4:
            raise AssertionError("balanced and cover evaluation differ")
        record["eval_gap"] = gap
        self.tie_free_data = tf
        try:
            trainer(tight, balanced_batches=True, device_sampling=True)
        except ValueError as e:
            log(f"  balanced_batches with device_sampling raises: {e}")
        else:
            raise AssertionError("balanced_batches with device_sampling "
                                 "did not raise")
        self.side_record["balanced"] = record
        self.balanced_trainer = replayed

    def layer0_operands(self, model, batch):
        """The scorer's (A, B) lists of ``model``'s layer 0 on ``batch``, as
        its forward builds them: per degree, its fixed then trainable set,
        sharing the degree's A."""
        from molkgnn_torch.ops.segment import take_rows

        enc = model.gnn_model
        layer = enc.gnn.layers[0]
        with self.torch.no_grad():
            x = enc.node_batch_norm(batch.x, mask=batch.node_mask)
            a_list, b_list = [], []
            for convs, b in zip(layer.degree_convs(), batch.buckets()):
                a = convs[0].support_a(take_rows(x, b.nei_index))
                for conv in convs:
                    a_list.append(a)
                    b_list.append(conv.support_b())
        return a_list, b_list

    def fixed_kernel_sets(self, tmp):
        """(b) of phase 10: the flagship with fixed sets at layer 0."""
        import numpy as np

        from molkgnn_torch.analyses.fixed_kernels import (
            KERNEL_FIELDS,
            capture_layer0_scores,
            load_customized_kernels,
            save_customized_kernels,
        )
        from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
        from molkgnn_torch.ops import support_score as ss
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        torch = self.torch
        rng = np.random.default_rng(SEED)
        sets = [
            {"x_center": rng.standard_normal((n, 28)),
             "x_support": rng.standard_normal((n, d, 28)),
             "edge_attr_support": rng.standard_normal((n, d, 7)),
             "p_support": rng.standard_normal((n, d, 3))}
            for d, n in enumerate(FIXED_KERNELS, 1)
        ]
        names = [[f"designed_deg{d}_{i}" for i in range(n)]
                 for d, n in enumerate(FIXED_KERNELS, 1)]
        root = os.path.join(tmp, "customized_kernels")
        save_customized_kernels(root, sets, names)
        fixed, got_names = load_customized_kernels(root)
        if list(map(list, got_names)) != names or any(
                not np.array_equal(f[k], np.float32(s[k]))
                for f, s in zip(fixed, sets) for k in KERNEL_FIELDS):
            raise AssertionError("customized_kernels/ did not read back")
        log(f"  customized_kernels/: {FIXED_KERNELS} fixed kernels for "
            f"degrees 1-4 written and read back")
        model = self.flagship(4, True, fixed_kernels=fixed).cuda()
        layer0 = model.gnn_model.gnn.layers[0]
        log(f"  layer 0 block widths {layer0.block_widths()} (fixed + "
            f"trainable); layer 1 reads "
            f"{model.gnn_model.gnn.layers[1].trainable_kernelconv_set[0].node_dim}"
            f" columns")

        # The 8-group layer-0 launch at the flagship's batch-1024 shapes.
        ds, cover = self.train_data
        batch = batch_graphs(ds.graphs[:BATCH], cover).to("cuda")
        model.eval()
        a_list, b_list = self.layer0_operands(model, batch)
        shapes8 = [(a.shape[0], a.shape[1], b.shape[2], b.shape[0])
                   for a, b in zip(a_list, b_list)]
        outs = ss.grouped_support_score(a_list, b_list)
        err = self.check_against_plain(f"grouped fixed layer 0, 8 groups "
                                       f"{shapes8}", outs, a_list, b_list)
        a4, b4 = a_list[1::2], b_list[1::2]
        shapes4 = shapes8[1::2]
        fn8 = lambda: ss.grouped_support_score(a_list, b_list)  # noqa: E731
        fn4 = lambda: ss.grouped_support_score(a4, b4)  # noqa: E731
        with torch.no_grad():
            t8 = self.time_launch(fn8, a_list, b_list)
            t4 = self.time_launch(fn4, a4, b4)
            # Device time by events over captured launches, in turns.
            graph = {8: [], 4: []}
            for g, fn in ((8, fn8), (4, fn4), (4, fn4), (8, fn8)):
                graph[g].append(graph_ms(torch, fn))
        self.log_times("grouped fixed layer 0, 8 groups", t8, shapes8)
        self.log_times("the same layer's 4 trainable groups", t4, shapes4)
        b8_ms, b8_by = bound_ms(shapes8)
        b4_ms = bound_ms(shapes4)[0]
        log(f"  device ms a launch by events over a captured graph of 50 "
            f"launches (8, 4, 4, 8 groups): 8 groups {graph[8]} (bound "
            f"{b8_ms:.4f}, share {b8_ms / min(graph[8]):.3f}), 4 groups "
            f"{graph[4]} (bound {b4_ms:.4f}, share "
            f"{b4_ms / min(graph[4]):.3f}); 8 over 4 "
            f"{min(graph[8]) / min(graph[4]):.3f}")
        record = {"shapes": shapes8, "max_abs_err": err,
                  "ms_8": t8, "graph_ms_8": graph[8], "bound_ms_8": b8_ms,
                  "bound_by_8": b8_by, "ms_4": t4, "graph_ms_4": graph[4],
                  "bound_ms_4": b4_ms}

        # 3 optimizer steps and an evaluation, counted: the fixed tensors
        # stay bit-equal, the score weights move.
        fixed_set = layer0.fixed_kernelconv_set
        start = {(d, k): getattr(c, k).clone() for d, c in fixed_set.items()
                 for k in KERNEL_FIELDS}
        weights = {d: torch.stack([c.support_attr_sc_weight.detach(),
                                   c.center_attr_sc_weight.detach(),
                                   c.edge_attr_support_sc_weight.detach()])
                   for d, c in fixed_set.items()}
        trainer = Trainer(model, ds, cover, TrainConfig(
            batch_size=BATCH, progress=False,
            log_dir=os.path.join(tmp, "fixed")))
        batches = [ids for ids in trainer._epoch_id_batches()][:3]
        reset_launches()
        losses = [float(trainer._step_ids(ids)) for ids in batches]
        _, pred = trainer._predict_ids(ds.split["valid"])
        launches = launch_counts()
        self.side_launches["fixed"] = launches
        want = 4 * (3 + -(-len(ds.split["valid"]) // BATCH))
        moved = {d: float((torch.stack([
            c.support_attr_sc_weight, c.center_attr_sc_weight,
            c.edge_attr_support_sc_weight]).detach() - weights[d]).abs().max())
            for d, c in fixed_set.items()}
        equal = all(torch.equal(getattr(fixed_set[d], k), t)
                    for (d, k), t in start.items())
        log(f"  3 steps + evaluation with fixed sets: losses "
            f"{[round(x, 6) for x in losses]}; launches {launches} (want "
            f"{want} grouped); fixed tensors bit-equal {equal}; score "
            f"weights moved by {moved}")
        if scorer_launches(launches) != {"grouped_support_score": want,
                        "fused_support_score": 0}:
            raise AssertionError(f"fixed-kernel launches {launches}")
        check_backward(launches, len(batches), "fixed sets")
        if not equal or min(moved.values()) <= 0:
            raise AssertionError("fixed tensors moved or score weights "
                                 "did not")
        if not (np.isfinite(losses).all() and np.isfinite(pred).all()):
            raise AssertionError("fixed-kernel losses or predictions")
        record.update(losses=losses, launches=launches, score_weight_moved=
                      moved)

        # Score capture on the card against the CPU, tie-free molecules.
        graphs = self.tie_free_data.graphs[:256]
        small = batch_graphs(graphs, spec_for_graphs(graphs, 256))
        got = capture_layer0_scores(model, small.to("cuda"))
        on_cpu = self.flagship(4, False, fixed_kernels=fixed)
        on_cpu.load_state_dict(model.state_dict())
        want_scores = capture_layer0_scores(on_cpu, small)
        gap = float(np.abs(got - want_scores).max())
        log(f"  capture_layer0_scores {got.shape} on the card against the "
            f"CPU, 256 tie-free molecules: max |difference| {gap:.3e}")
        if gap > 1e-4 or got.shape[1] != sum(layer0.block_widths()):
            raise AssertionError("captured scores differ from the CPU's")
        record["capture_gap"] = gap
        self.side_record["fixed"] = record
        self.fixed_times = (t8, shapes8, err, t4, graph)

    def balanced_cli(self, tmp):
        """(c) of phase 10: the CLI with --balanced_batches on phase 6's SDF
        pair, counted; with --device_sampling it is refused."""
        import numpy as np

        from molkgnn_torch.cli import entry
        from molkgnn_torch.tools.enantiomer import parse_test_result

        ds, _ = self.cli_data
        sizes = {k: len(v) for k, v in ds.split.items()}
        out = os.path.join(tmp, "cli_balanced")
        common = ["--dataset_name", "1798", "--dataset_path",
                  os.path.join(tmp, "dataset"), "--batch_size", "32",
                  "--enable_oversampling_with_replacement",
                  "--balanced_batches", "--max_epochs", "1"]
        reset_launches()
        t0 = time.perf_counter()
        rc = entry.main(common + ["--scan_steps", "16",
                                  "--default_root_dir", out])
        secs = time.perf_counter() - t0
        launches = launch_counts()
        self.side_launches["balanced_cli"] = launches
        if rc != 0:
            raise AssertionError(f"the balanced CLI returned {rc}")
        logs = os.path.join(out, "logs")
        tested = parse_test_result(os.path.join(logs, "test_result.log"))
        steps = -(-sizes["train"] // 32)
        eval_batches = (-(-sizes["valid"] // 32)
                        + (len(tested) + 1) * -(-sizes["test"] // 32))
        want = 4 * (steps + eval_batches)
        files = ["history.json", "test_result.log", "task_info.log",
                 "kernels/kernels.npz", "graph_embedding.npy"] + [
            f"test_sample_scores_{tag}.log" for tag in tested]
        missing = [f for f in files
                   if not os.path.exists(os.path.join(logs, f))]
        with open(os.path.join(logs, "history.json")) as f:
            history = json.load(f)
        finite = all(np.isfinite(m[k]) for m in tested.values()
                     for k in ("AUC", "logAUC_0.001_0.1", "logAUC_0.001_1"))
        log(f"  CLI --balanced_batches --scan_steps 16, 1 epoch at batch "
            f"32 in {secs:.1f} s: {steps} steps, {eval_batches} evaluation "
            f"batches; launches {launches} (want {want} grouped); train "
            f"loss {history[0]['train_loss']:.4f}; test [last] AUC "
            f"{tested['last']['AUC']:.4f}")
        if missing or not finite or not np.isfinite(history[0]["train_loss"]):
            raise AssertionError(f"balanced CLI: missing {missing}, "
                                 f"metrics {tested}")
        if scorer_launches(launches) != {"grouped_support_score": want,
                        "fused_support_score": 0}:
            raise AssertionError(f"balanced CLI launches {launches}")
        check_backward(launches, steps, "balanced CLI")
        try:
            rc = entry.main(common + ["--device_sampling", "--scan_steps",
                                      "16", "--default_root_dir",
                                      os.path.join(tmp, "cli_refused")])
        except ValueError as e:
            log(f"  CLI --balanced_batches --device_sampling refused: {e}")
        else:
            raise AssertionError(f"--balanced_batches --device_sampling "
                                 f"returned {rc}")
        self.side_record["cli"] = {"seconds": secs, "launches": launches,
                                   "steps": steps, "test": tested}

    def monitors_and_sweep(self, tmp):
        """(d) of phase 10: a profiler region around two replayed steps,
        and a 2-point sweep through the port's CLI in subprocesses on the
        card, aggregated, then resumed."""
        from molkgnn_torch.experiments.aggregate import aggregate_results
        from molkgnn_torch.experiments.sweep import SweepConfig, run_sweep
        from molkgnn_torch.training.monitors import profiler_trace

        torch = self.torch
        trainer = self.balanced_trainer
        ids = torch.as_tensor(next(trainer._epoch_id_batches()),
                              device="cuda")
        trace_dir = os.path.join(tmp, "trace")
        with profiler_trace(trace_dir) as prof:
            for _ in range(2):
                trainer._graph_step(ids)
            torch.cuda.synchronize()
        path = os.path.join(trace_dir, "trace.json")
        rows = device_rows(prof)
        scorer = [r for r in rows if KERNEL_NAME in r[2]]
        size = os.path.getsize(path) if os.path.exists(path) else 0
        log(f"  profiler_trace around 2 replayed steps: {path} "
            f"({size} bytes), {len(rows)} kernels with device time, the "
            f"scorer's {sum(r[1] for r in scorer)} launches "
            f"{sum(r[0] for r in scorer):.3f} ms")
        if not size or not scorer:
            raise AssertionError("the profiler region recorded no trace or "
                                 "no scorer kernel")

        cfg = SweepConfig(
            base_args={"dataset_name": "synthetic_motif", "max_epochs": 1},
            grid={"peak_lr": [5e-3, 5e-2]},
            out_dir=os.path.join(tmp, "sweep"), max_parallel=2)
        cwd = os.getcwd()
        os.chdir(os.path.dirname(os.path.abspath(__file__)))  # -m imports
        try:
            t0 = time.perf_counter()
            records = run_sweep(cfg)
            secs = time.perf_counter() - t0
            again = run_sweep(cfg)
        finally:
            os.chdir(cwd)
        tables = aggregate_results(cfg.out_dir)
        statuses = [r["status"] for r in records]
        log(f"  sweep of 2 runs of molkgnn_torch.cli.entry on the card in "
            f"{secs:.1f} s: {statuses}; AUC table {tables.get('AUC')}; "
            f"again: {[r['status'] for r in again]}")
        if statuses != ["ok", "ok"]:
            for r in records:
                with open(os.path.join(r["dir"], "run.log")) as f:
                    log(f.read()[-2000:])
            raise AssertionError("a sweep run failed")
        if len(tables["AUC"]) != 3 or [r["status"] for r in again] != [
                "done", "done"]:
            raise AssertionError("sweep aggregation or resume")
        self.side_record["monitors"] = {"trace_bytes": size,
                                        "sweep_s": secs, "tables": tables}

    # ------------------------------------------------------------ phase 11
    def phase_dp(self, graphs, spec, tmp):
        """Data parallel on torch.distributed (see the module doc): (a) one
        NCCL rank, replayed; (b) two gloo ranks sharing the card; (c)
        screening and evaluation at world 1; (d) the CLI under
        torch.distributed.run. Each main path counts the scorer's launches
        from 0."""
        import torch.distributed as dist

        from molkgnn_torch.data.dataset import make_tie_free_dataset

        t_phase = time.perf_counter()
        self.dp_record, self.dp_launches = {}, {}
        ds = getattr(self, "tie_free_data", None) or make_tie_free_dataset(
            NUM_MOLECULES, NUM_MOLECULES * 3 // 4, seed=SEED)
        try:
            self.dp_world_one(ds)
            self.dp_screen_eval(graphs, spec, ds)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        self.dp_two_ranks(ds, tmp)
        self.dp_cli(tmp)
        secs = time.perf_counter() - t_phase
        self.dp_record["seconds"] = secs
        log(f"  phase 11 took {secs:.1f} s")

    def dp_trainer(self, ds, mesh, **kw):
        from molkgnn_torch.graphs.batch import spec_for_graphs
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        model = self.flagship(4, True, seed=SEED + 11)
        return Trainer(model, ds, spec_for_graphs(ds.graphs, BATCH),
                       TrainConfig(batch_size=BATCH, progress=False, **kw),
                       mesh=mesh)

    def dp_world_one(self, ds):
        """(a) of phase 11: Trainer(mesh=make_mesh(1)) with scan_steps=16,
        on host ids and with device sampling, beside the single-device
        Trainer from the same weights."""
        import numpy as np
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from molkgnn_torch.parallel.data_parallel import make_mesh

        torch = self.torch
        mesh = make_mesh(1)
        backend = torch.distributed.get_backend()
        if backend != "nccl":
            raise AssertionError(f"a CUDA mesh runs {backend}, not NCCL")
        single = self.dp_trainer(ds, None, scan_steps=16)
        dp = self.dp_trainer(ds, mesh, scan_steps=16)
        blocks = np.stack(list(single._epoch_id_batches()))[:3]
        losses = {"single": [], "dp": []}
        for ids in blocks:
            ids = torch.as_tensor(ids, device="cuda")
            losses["single"].append(float(single._graph_step(ids)))
            losses["dp"].append(float(dp._graph_step(ids)))
        if dp._graph is None:
            raise AssertionError("the world-1 DP step was not captured")
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(losses["dp"], losses["single"]))
        sd = single.model.state_dict()
        diff = max((v - sd[k]).abs().max().item()
                   for k, v in dp.model.state_dict().items())
        log(f"  world-1 NCCL DP (captured, the all-reduce inside the graph) "
            f"against one device, 3 steps on the same ids: losses "
            f"{losses['dp']} / {losses['single']}, max relative difference "
            f"{rel:.3e}, max parameter difference {diff:.3e}; all-reduced "
            f"bucket {dp._sync.nbytes} bytes a step")
        if rel > 1e-5 or diff > 1e-5:
            raise AssertionError("world-1 DP and one device differ by > 1e-5")
        sampled = self.dp_trainer(ds, mesh, scan_steps=16,
                                  device_sampling=True)
        single_sampled = self.dp_trainer(ds, None, scan_steps=16,
                                         device_sampling=True)
        # The main paths, counted: an epoch of each DP trainer (the
        # sampled one's holds its warm-up steps and capture).
        for name, trainer in (("dp_world1", dp), ("dp_sampling", sampled)):
            reset_launches()
            steps = trainer._epoch_steps()
            torch.cuda.synchronize()
            counts = launch_counts()
            self.dp_launches[name] = counts
            if scorer_launches(counts) != {"grouped_support_score": 4 * len(steps),
                          "fused_support_score": 0}:
                raise AssertionError(f"{name}: launches {counts} for "
                                     f"{len(steps)} steps")
            check_backward(counts, len(steps), name)
            if not np.isfinite(torch.stack(steps).cpu().numpy()).all():
                raise AssertionError(f"{name}: a loss is not finite")
            log(f"  {name}: {len(steps)} steps, scorer launches {counts}")
        trainers = {"single": (single, 4), "dp world 1": (dp, 4),
                    "single+sampling": (single_sampled, 4),
                    "dp world 1+sampling": (sampled, 4)}
        names = list(trainers)
        rates = self.epoch_rates(trainers, names + names[::-1],
                                 "flagship b1024 scan_steps=16")
        replays = {}
        for name in ("single", "dp world 1", "dp world 1", "single"):
            rec = self.replay_profile(trainers[name][0], f"{name} replayed")
            replays.setdefault(name, []).append(rec)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(16):
                dp._graph_step()
            torch.cuda.synchronize()
        nccl = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and "nccl" in e.key.lower() and e.self_device_time_total > 0]
        nccl_ms = sum(r[0] for r in nccl) / 16
        log(f"  NCCL kernels in 16 DP replays: "
            f"{[(round(ms, 4), n, k[:60]) for ms, n, k in nccl]}; "
            f"{nccl_ms:.4f} ms a step (0 where NCCL launched no kernel)")
        self.dp_record["world1"] = {
            "max_rel_loss_diff": rel, "max_param_diff": diff,
            "bucket_bytes": dp._sync.nbytes, "graphs_per_s": rates,
            "replays": replays, "nccl_ms_per_step": nccl_ms,
            "launches": {k: self.dp_launches[k]
                         for k in ("dp_world1", "dp_sampling")},
        }
        self.dp_trainers = (single, dp, mesh)

    def dp_screen_eval(self, graphs, spec, ds):
        """(c) of phase 11: screen_library(mesh=make_mesh(1)) beside the
        single-device screen over phase 7's library; scores held on
        tie-free molecules; DP evaluation at world 1 against one device."""
        import numpy as np

        from molkgnn_torch.graphs.batch import spec_for_graphs
        from molkgnn_torch.serving.predictor import Predictor

        torch = self.torch
        single, dp, mesh = self.dp_trainers
        model = self.flagship(4, True)
        pred = Predictor(model, model.state_dict(), spec)
        library = list(graphs) * SCREEN_REPEAT
        n = len(library)
        blocks = sum(-(-min(SLAB, n - s) // BATCH) for s in range(0, n, SLAB))
        secs = {"single": [], "dp": []}
        for i, name in enumerate(("dp", "single", "single", "dp")):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.screen_library(library, slab=SLAB,
                                mesh=mesh if name == "dp" else None)
            secs[name].append(time.perf_counter() - t0)
            if i == 0:  # the DP main path, counted
                counts = launch_counts()
                self.dp_launches["dp_screen"] = counts
                if scorer_launches(counts) != {"grouped_support_score": 4 * blocks,
                              "fused_support_score": 0}:
                    raise AssertionError(f"DP screening launches {counts}")
                check_backward(counts, 0, "DP screening")
        card = torch.cuda.get_device_name(0)
        for name, s in secs.items():
            log(f"  screen_library {name} on {card}: "
                f"{[round(n / x, 1) for x in s]} graphs/s ({n} molecules)")
        mols = ds.graphs[:2048]
        tf = Predictor(model, model.state_dict(), spec_for_graphs(mols, BATCH))
        gap = float(np.abs(tf.screen_library(mols, slab=1200, mesh=mesh)
                           - tf.screen_library(mols, slab=1200)).max())
        dp.model.load_state_dict(single.model.state_dict())
        ids = np.asarray(ds.split["valid"])
        reset_launches()
        _, got = dp._predict_ids(ids)
        counts = launch_counts()
        _, want = single._predict_ids(ids)
        eval_gap = float(np.abs(got - want).max())
        self.dp_launches["dp_eval"] = counts
        log(f"  tie-free: DP screen_library against one device max |diff| "
            f"{gap:.3e} (2048 molecules, 2 slabs); DP evaluation of "
            f"{len(ids)} molecules against one device {eval_gap:.3e}, "
            f"launches {counts}")
        if gap > 1e-5 or eval_gap > 1e-5:
            raise AssertionError("DP screening or evaluation differs")
        want_eval = 4 * -(-len(ids) // BATCH)
        if scorer_launches(counts) != {"grouped_support_score": want_eval,
                      "fused_support_score": 0}:
            raise AssertionError(f"DP evaluation launches {counts}")
        check_backward(counts, 0, "DP evaluation")
        self.dp_record["screen"] = {
            "molecules": n, "seconds": secs,
            "graphs_per_s": {k: [n / x for x in v] for k, v in secs.items()},
            "tie_free_gap": gap, "eval_gap": eval_gap,
        }

    def dp_two_ranks(self, ds, tmp):
        """(b) of phase 11: two ranks sharing the card over gloo (NCCL
        refuses two ranks on one device), spawned by the port's launcher:
        gloo's all_reduce and all_gather on CUDA tensors, DP evaluation at
        world 2 (3 blocks, padded to 4), and 3 eager steps against a plain
        DP step in this process."""
        import pickle

        import numpy as np

        from molkgnn_torch.parallel import launch
        from molkgnn_torch.parallel.data_parallel import batch_norm_buffers
        from molkgnn_torch.training.optim import fill_missing_grads

        torch = self.torch
        path = os.path.join(tmp, "dp2")
        os.makedirs(path, exist_ok=True)
        rng = np.random.default_rng(SEED + 11)
        train = np.asarray(ds.split["train"], np.int32)
        job = {"ids": rng.choice(train, (3, 2, BATCH)).astype(np.int32),
               "eval": train[:2 * BATCH + BATCH // 2]}
        with open(os.path.join(path, "job.pkl"), "wb") as f:
            pickle.dump((ds, job), f)
        t0 = time.perf_counter()
        launch.spawn(_dp_rank, 2, args=(path,), backend="gloo")
        spawn_s = time.perf_counter() - t0
        with open(os.path.join(path, "rank0.pkl"), "rb") as f:
            ranks = pickle.load(f)

        plain = self.dp_trainer(ds, None)
        _, want_eval = plain._predict_ids(job["eval"])
        bn = batch_norm_buffers(plain.model)
        for step in range(3):
            start_bn = [b.clone() for b in bn]
            masks = plain.dropout_rng.get_state()
            grads, stats = [], []
            for r in range(2):
                for b, v in zip(bn, start_bn):
                    b.copy_(v)
                plain.dropout_rng.set_state(masks)
                ids = torch.as_tensor(job["ids"][step, r], device="cuda")
                plain._loss(plain._gather(plain._device_data, ids,
                                          plain.spec)).backward()
                fill_missing_grads(plain._params)
                grads.append([p.grad.clone() for p in plain._params])
                stats.append([b.clone() for b in bn])
            with torch.no_grad():
                for p, g0, g1 in zip(plain._params, *grads):
                    p.grad.copy_((g0 + g1) / 2)
                for b, s0, s1 in zip(bn, *stats):
                    b.copy_((s0 + s1) / 2)
            plain._update()
        sd = plain.model.state_dict()
        diff = max((v.cuda() - sd[k]).abs().max().item()
                   for k, v in ranks["state"].items())
        eval_gap = float(np.abs(ranks["eval"] - want_eval).max())
        log(f"  2 gloo ranks on one card (spawned in {spawn_s:.1f} s): "
            f"gloo all_reduce/all_gather on CUDA tensors {ranks['gloo']}; "
            f"3 eager steps {ranks['step_ms']} ms (rank 0, host clock, "
            f"synchronised), losses {ranks['losses']}; parameters against "
            f"the plain DP step max |diff| {diff:.3e}; world-2 evaluation "
            f"of {len(job['eval'])} molecules (3 blocks on 2 ranks) against "
            f"one device {eval_gap:.3e}; rank 0's scorer launches "
            f"{ranks['launches']}")
        if diff > 1e-5 or eval_gap > 1e-5:
            raise AssertionError("2-rank gloo DP differs from the plain DP "
                                 "step or single-device evaluation")
        want = 4 * (3 + 2)  # 3 steps, 2 of the 4 padded blocks
        if scorer_launches(ranks["launches"]) != {
                "grouped_support_score": want,
                                 "fused_support_score": 0}:
            raise AssertionError(f"rank 0 launches {ranks['launches']}")
        check_backward(ranks["launches"], 3, "DP rank 0 of 2")
        self.dp_launches["dp_two_ranks"] = ranks["launches"]
        self.dp_record["two_ranks"] = {
            "spawn_s": spawn_s, "step_ms": ranks["step_ms"],
            "max_param_diff": diff, "eval_gap": eval_gap,
            "gloo": ranks["gloo"],
        }

    def dp_cli(self, tmp):
        """(d) of phase 11: the CLI under torch.distributed.run (one NCCL
        rank) on phase 6's SDF pair, counted; --test on its root in this
        process; --num_devices 2 refused on a one-card machine."""
        import numpy as np

        from molkgnn_torch.cli import entry
        from molkgnn_torch.tools.enantiomer import (
            SAMPLING_ARGS,
            parse_test_result,
        )

        ds, _ = self.cli_data
        sizes = {k: len(v) for k, v in ds.split.items()}
        out = os.path.join(tmp, "cli_dp")
        common = ["--dataset_name", "1798", "--dataset_path",
                  os.path.join(tmp, "dataset"), *SAMPLING_ARGS]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "molkgnn_torch.cli.entry",
             *common, "--max_epochs", "1", "--default_root_dir", out],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"torch.distributed.run CLI: exit "
                                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
        logs = os.path.join(out, "logs")
        tested = parse_test_result(os.path.join(logs, "test_result.log"))
        with open(os.path.join(logs, "task_info.log")) as f:
            info = f.read()
        launched = dict(
            (name, int(n)) for name, n in
            (part.split() for part in info.split("scorer_launches: ")[1]
             .splitlines()[0].split(", ")))
        steps = -(-sizes["train"] // 32)
        eval_batches = (-(-sizes["valid"] // 32)
                        + (len(tested) + 1) * -(-sizes["test"] // 32))
        want = 4 * (steps + eval_batches)
        with open(os.path.join(logs, "history.json")) as f:
            history = json.load(f)
        finite = all(np.isfinite(m[k]) for m in tested.values()
                     for k in ("AUC", "logAUC_0.001_0.1", "logAUC_0.001_1"))
        log(f"  CLI under torch.distributed.run --nproc_per_node 1 "
            f"(NCCL, --device_sampling --scan_steps 16, 1 epoch at batch "
            f"32) in {secs:.1f} s: {steps} steps, {eval_batches} "
            f"evaluation batches; task_info.log: "
            f"{info.count('task_name:')} run, scorer launches {launched} "
            f"(want {want} grouped); train loss "
            f"{history[0]['train_loss']:.4f}; test [last] AUC "
            f"{tested['last']['AUC']:.4f}")
        if ("ranks: 1" not in info or info.count("task_name:") != 1
                or not finite or not np.isfinite(history[0]["train_loss"])):
            raise AssertionError(f"DP CLI artifacts: {info!r} {tested}")
        if launched["segment_sum"] <= 0 or scorer_launches(launched) != {
                "fused_support_score": 0, "grouped_support_score": want}:
            raise AssertionError(f"DP CLI launches {launched}")
        check_backward(launched, steps, "DP CLI")
        self.dp_launches["dp_cli"] = launched

        def scores():
            return {tag: np.loadtxt(os.path.join(
                logs, f"test_sample_scores_{tag}.log"), delimiter=",")
                for tag in tested}

        before = scores()
        if entry.main(common + ["--default_root_dir", out, "--test"]) != 0:
            raise AssertionError("--test on the DP CLI's root failed")
        after = scores()
        pred_gap = max(float(np.abs(after[t][:, 0] - b[:, 0]).max())
                       for t, b in before.items())
        log(f"  --test on its root: largest prediction difference "
            f"{pred_gap:.3e}")
        if pred_gap > 1e-4:
            raise AssertionError("--test predictions differ from the fit's")
        cards = self.torch.cuda.device_count()
        try:
            entry.main(["--num_devices", str(cards + 1), "--dataset_name",
                        "synthetic", "--default_root_dir",
                        os.path.join(tmp, "cli_refused_dp")])
            message = None
        except SystemExit as e:
            message = str(e)
        log(f"  --num_devices {cards + 1} on {cards} card(s): {message}")
        if not message or f"has {cards}" not in message or (
                f"{cards + 1} CUDA devices" not in message):
            raise AssertionError(f"--num_devices {cards + 1} was not "
                                 "refused naming both numbers")
        self.dp_record["cli"] = {"seconds": secs, "launches": launched,
                                 "test": tested, "retest_gap": pred_gap,
                                 "refused": message}

    # ------------------------------------------------------------ phase 12
    def phase_mp(self, tmp):
        """Model parallelism on torch.distributed (see the module doc): (a)
        one NCCL rank, halo, replayed; (b) four gloo ranks sharing the
        card; (c) the CLI under torch.distributed.run; (d) the hybrid
        refusal. Each main path counts the scorer's launches from 0."""
        import torch.distributed as dist

        from molkgnn_torch.data.dataset import make_tie_free_dataset

        t_phase = time.perf_counter()
        self.mp_record, self.mp_launches = {}, {}
        ds = getattr(self, "tie_free_data", None) or make_tie_free_dataset(
            NUM_MOLECULES, NUM_MOLECULES * 3 // 4, seed=SEED)
        try:
            self.mp_world_one(ds)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        self.mp_four_ranks(ds, tmp)
        self.mp_cli(tmp)
        secs = time.perf_counter() - t_phase
        self.mp_record["seconds"] = secs
        log(f"  phase 12 took {secs:.1f} s")

    def mp_trainer(self, ds, mesh, batch=BATCH, **kw):
        """The flagship (dropout 0) Trainer of phase 12 at ``batch``."""
        from molkgnn_torch.graphs.batch import spec_for_graphs
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        model = self.flagship(4, True, seed=SEED + 12, dropout=0.0)
        return Trainer(model, ds, spec_for_graphs(ds.graphs, batch),
                       TrainConfig(batch_size=batch, progress=False, **kw),
                       mesh=mesh)

    def mp_world_one(self, ds):
        """(a) of phase 12: halo on one NCCL rank, replayed, beside the
        single-device Trainer; the host-fed halo epoch and its
        partitioner."""
        import numpy as np
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from molkgnn_torch.data.dataset import GraphLoader
        from molkgnn_torch.parallel.data_parallel import make_mesh
        from molkgnn_torch.parallel.halo import halo_stats, partition_halo

        torch = self.torch
        mesh = make_mesh(1)
        single = self.mp_trainer(ds, None, scan_steps=16,
                                 device_sampling=True)
        halo = self.mp_trainer(ds, mesh, scan_steps=16, device_sampling=True,
                               model_parallel="halo")
        losses = {"single": [], "halo": []}
        for _ in range(3):  # 2 warm-up steps, then the capture's replay
            losses["single"].append(float(single._graph_step()))
            losses["halo"].append(float(halo._graph_step()))
        if halo._graph is None:
            raise AssertionError("the world-1 halo step was not captured")
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(losses["halo"], losses["single"]))
        sd = single.model.state_dict()
        diff = max((v - sd[k]).abs().max().item()
                   for k, v in halo.model.state_dict().items())
        log(f"  world-1 NCCL halo (device sampling, the exchanges captured "
            f"in the step) against one device, the first 3 steps of the "
            f"same stream: losses {losses['halo']} / {losses['single']}, "
            f"max relative difference {rel:.3e}, max parameter difference "
            f"{diff:.3e}")
        if rel > 1e-5 or diff > 1e-5:
            raise AssertionError("world-1 halo and one device differ by "
                                 "> 1e-5")
        reset_launches()  # the main path, counted: an epoch of halo
        steps = halo._epoch_steps()
        torch.cuda.synchronize()
        counts = launch_counts()
        self.mp_launches["mp_world1"] = counts
        if scorer_launches(counts) != {"grouped_support_score": 4 * len(steps),
                      "fused_support_score": 0}:
            raise AssertionError(f"world-1 halo: launches {counts} for "
                                 f"{len(steps)} steps")
        check_backward(counts, len(steps), "world-1 halo")
        if not np.isfinite(torch.stack(steps).cpu().numpy()).all():
            raise AssertionError("world-1 halo: a loss is not finite")
        log(f"  world-1 halo epoch: {len(steps)} steps, scorer launches "
            f"{counts}")
        trainers = {"single+sampling": (single, 4),
                    "halo world 1+sampling": (halo, 4)}
        names = list(trainers)
        rates = self.epoch_rates(trainers, names + names[::-1],
                                 "flagship b1024 scan_steps=16")
        replays = {name: self.replay_profile(trainers[name][0],
                                             f"{name} replayed")
                   for name in names[::-1]}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(16):
                halo._graph_step()
            torch.cuda.synchronize()
        nccl = [(e.self_device_time_total / 1e3, e.count, e.key)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and "nccl" in e.key.lower() and e.self_device_time_total > 0]
        nccl_ms = sum(r[0] for r in nccl) / 16
        nccl_exchange = exchange_ms(torch, 1, mesh.get_group("data"), 1)
        log(f"  NCCL kernels in 16 halo replays: "
            f"{[(round(ms, 4), n, k[:60]) for ms, n, k in nccl]}; "
            f"{nccl_ms:.4f} ms a step (0 where NCCL launched no kernel); "
            f"one eager world-1 NCCL exchange of [1, 1, "
            f"{sum(FLAGSHIP_KERNELS)}] {nccl_exchange:.4f} ms (host clock, "
            f"synchronised)")

        # The host-fed halo epoch: the host loader's batches partitioned
        # with pinned capacities, eager steps.
        host = self.mp_trainer(ds, mesh, model_parallel="halo")
        loader = GraphLoader(ds.subset("train"), host.spec, BATCH,
                             oversample=True, seed=host.id_rng)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host_losses = host._mp_epoch(loader)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        counts = launch_counts()
        self.mp_launches["mp_host"] = counts
        if scorer_launches(counts) != {"grouped_support_score": 4 * len(host_losses),
                      "fused_support_score": 0}:
            raise AssertionError(f"host-fed halo: launches {counts}")
        check_backward(counts, len(host_losses), "host-fed halo")
        batches = list(loader)
        part_s = {}
        for shards in (1, 4):
            t0 = time.perf_counter()
            parts = [partition_halo(b, shards) for b in batches]
            part_s[shards] = (time.perf_counter() - t0) / len(batches)
        stats = halo_stats(parts[0])
        width = sum(FLAGSHIP_KERNELS)
        exch_bytes = stats["halo_rows_per_exchange"] * width * 4
        host_rate = len(host_losses) * BATCH / host_s
        log(f"  host-fed halo epoch (world 1, eager): {len(host_losses)} "
            f"steps in {host_s:.3f} s, {host_rate:.1f} graphs/s, launches "
            f"{counts}; host partitioner {part_s[1]:.4f} s a batch at 1 "
            f"shard, {part_s[4]:.4f} s at 4; halo_stats at 4 shards "
            f"{stats}: an exchange of {width}-wide fp32 rows moves "
            f"{exch_bytes} bytes a rank")
        self.mp_record["world1"] = {
            "max_rel_loss_diff": rel, "max_param_diff": diff,
            "graphs_per_s": rates, "replays": replays,
            "nccl_ms_per_step": nccl_ms, "nccl_exchange_ms": nccl_exchange,
            "host_graphs_per_s": host_rate,
            "partition_s_per_batch": part_s, "halo_stats_4": stats,
            "exchange_bytes_4": exch_bytes,
            "launches": {k: self.mp_launches[k]
                         for k in ("mp_world1", "mp_host")},
        }

    def mp_four_ranks(self, ds, tmp):
        """(b) of phase 12: four gloo ranks sharing the card (NCCL refuses
        two ranks on one device), one spawn: halo, hybrid and the edge
        partition against one device in this process."""
        import pickle

        import numpy as np

        from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
        from molkgnn_torch.parallel import launch
        from molkgnn_torch.training.optim import fill_missing_grads

        torch = self.torch
        path = os.path.join(tmp, "mp4")
        os.makedirs(path, exist_ok=True)
        rng = np.random.default_rng(SEED + 12)
        train = np.asarray(ds.split["train"], np.int32)
        job = {"halo": rng.choice(train, (3, BATCH)),
               "hybrid": rng.choice(train, (2, BATCH))}
        with open(os.path.join(path, "job.pkl"), "wb") as f:
            pickle.dump((ds, job), f)
        t0 = time.perf_counter()
        launch.spawn(_mp_rank, 4, args=(path,), backend="gloo")
        spawn_s = time.perf_counter() - t0
        with open(os.path.join(path, "rank0.pkl"), "rb") as f:
            ranks = pickle.load(f)

        def rel_gap(got, want):
            return float((got - want).abs().max()
                         / want.abs().max().clamp(min=1e-30))

        plain = self.mp_trainer(ds, None)
        batches = [batch_graphs([ds.graphs[i] for i in row], plain.spec)
                   .to("cuda") for row in job["halo"]]
        plain.model.eval()
        with torch.no_grad():
            logits, pooled = plain.model(batches[0])
        eval_gap = rel_gap(ranks["eval"].cuda(), logits)
        edge_gap = rel_gap(ranks["edge"].cuda(), pooled)

        def grad_gap(got, want):
            """The gradients as one vector: the norm of the difference
            over the norm (a scalar weight's gradient sums many cancelling
            terms, so its own relative difference follows the summation
            order)."""
            got = torch.cat([got[n].cuda().reshape(-1) for n in want])
            want = torch.cat([g.reshape(-1) for g in want.values()])
            return float((got - want).norm() / want.norm())

        # Each halo step against one device's step from the same state:
        # its gradients at the ranks' own state before it, and its update
        # against one device's optimizer fed the ranks' gradients. The
        # first step starts from the same weights: its gradients and
        # parameters are held within 1e-5. A later step's weights have
        # been trained, and a neighbourhood's top two permutation scores
        # may then lie within the summation noise, so that the shards'
        # other order flips its argmax: a discrete gradient change, held
        # within 1e-3. (Adam also divides a gradient element of the order
        # of its eps, 1e-8, by itself, so such an element's update can
        # move by up to the learning rate: one device's own 3 steps are
        # printed beside, not held.)
        grad_gaps = []
        for t, batch in enumerate(batches):
            plain.model.load_state_dict(
                {k: v.cuda() for k, v in ranks["states"][t].items()})
            plain._loss(batch).backward()
            fill_missing_grads(plain._params)
            want = {n: p.grad for n, p in plain.model.named_parameters()}
            grad_gaps.append(grad_gap(ranks["grads"][t], want))
            if t == 0:
                worst = max(rel_gap(ranks["grads"][0][n].cuda(), g)
                            for n, g in want.items() if g.abs().max() > 0)
        fed = self.mp_trainer(ds, None)
        names = dict(fed.model.named_parameters())
        for g in ranks["grads"]:
            with torch.no_grad():
                for n, p in names.items():
                    p.grad = g[n].cuda().clone()
            fed._update()
        fed_diff = max((ranks["halo"][n].cuda() - p).abs().max().item()
                       for n, p in names.items())
        own = self.mp_trainer(ds, None)
        own._step(batches[0])
        sd = own.model.state_dict()
        step1_diff = max((v.cuda() - sd[k]).abs().max().item()
                         for k, v in ranks["states"][1].items())
        for batch in batches[1:]:
            own._step(batch)
        sd = own.model.state_dict()
        halo_diff = max((v.cuda() - sd[k]).abs().max().item()
                        for k, v in ranks["halo"].items())
        past = sum(int(((v.cuda() - sd[k]).abs() > 1e-5).sum())
                   for k, v in ranks["halo"].items())
        stats_diff = max((v.cuda() - sd[k]).abs().max().item()
                         for k, v in ranks["halo"].items() if "running" in k)
        wide = self.mp_trainer(ds, None, batch=2 * BATCH,
                               tot_iterations=MP_ITERATIONS)
        ids = np.concatenate(job["hybrid"])
        wide._step(batch_graphs([ds.graphs[i] for i in ids], wide.spec)
                   .to("cuda"))
        sd = wide.model.state_dict()
        hybrid_diff = max((v.cuda() - sd[k]).abs().max().item()
                          for k, v in ranks["hybrid"].items())
        log(f"  4 gloo ranks on one card (spawned in {spawn_s:.1f} s): "
            f"halo_stats {ranks['stats']}; halo eval forward against one "
            f"device {eval_gap:.3e} (relative to the largest logit); the "
            f"3 steps' gradients, each at the ranks' state before it, "
            f"{[f'{g:.3e}' for g in grad_gaps]} (relative, norm of the "
            f"difference over the norm; the first step's worst tensor by "
            f"its largest element {worst:.3e}); the 3 updates against one "
            f"device's optimizer fed the ranks' gradients {fed_diff:.3e}; "
            f"against one device's own steps: parameters after the first "
            f"{step1_diff:.3e}, after 3 {halo_diff:.3e} ({past} elements "
            f"past 1e-5), the BatchNorm statistics {stats_diff:.3e}; "
            f"3 eager halo "
            f"steps {ranks['step_ms']} ms (rank 0, host clock, "
            f"synchronised); hybrid 2x2 step against one device's step on "
            f"the 2048 graphs {hybrid_diff:.3e}; edge-partition forward "
            f"{edge_gap:.3e}; a gloo exchange of [4, "
            f"{ranks['stats']['halo_rows_per_exchange'] // 4}, "
            f"{sum(FLAGSHIP_KERNELS)}] fp32 {ranks['exchange_ms']:.3f} ms "
            f"(rank 0, host clock, synchronised); rank 0's scorer launches "
            f"{ranks['launches']}")
        if (max(eval_gap, grad_gaps[0], step1_diff, stats_diff, fed_diff,
                hybrid_diff, edge_gap) > 1e-5 or max(grad_gaps) > 1e-3):
            raise AssertionError("4 gloo ranks differ from one device")
        want = {"eval": 4, "halo": 4 * 3, "hybrid": 4, "edge": 4}
        got = {k: v["grouped_support_score"]
               for k, v in ranks["launches"].items()}
        if got != want or any(v["fused_support_score"]
                              for v in ranks["launches"].values()):
            raise AssertionError(f"rank 0 launches {ranks['launches']}")
        for path, steps in (("eval", 0), ("halo", 3), ("hybrid", 1),
                            ("edge", 0)):
            check_backward(ranks["launches"][path], steps,
                           f"MP rank 0 of 4, {path}")
        total = {name: sum(v[name] for v in ranks["launches"].values())
                 for name in (*REPLACES, "support_score_backward",
                              "segment_sum", "segment_plan")}
        self.mp_launches["mp_four_ranks"] = total
        self.mp_record["four_ranks"] = {
            "spawn_s": spawn_s, "step_ms": ranks["step_ms"],
            "halo_stats": ranks["stats"], "eval_gap": eval_gap,
            "grad_gaps": grad_gaps, "grad_worst_tensor_gap": worst,
            "step1_param_diff": step1_diff, "halo_param_diff": halo_diff,
            "elements_past_1e-5": past, "stats_diff": stats_diff,
            "fed_param_diff": fed_diff,
            "gloo_exchange_ms": ranks["exchange_ms"],
            "hybrid_param_diff": hybrid_diff, "edge_gap": edge_gap,
        }

    def mp_cli(self, tmp):
        """(c) and (d) of phase 12: the halo CLI under
        torch.distributed.run (one NCCL rank) on phase 6's SDF pair,
        counted; the hybrid CLI on two ranks refused on a one-card
        machine."""
        import numpy as np

        from molkgnn_torch.cli import entry
        from molkgnn_torch.tools.enantiomer import (
            SAMPLING_ARGS,
            parse_test_result,
        )

        ds, _ = self.cli_data
        sizes = {k: len(v) for k, v in ds.split.items()}
        out = os.path.join(tmp, "cli_halo")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "molkgnn_torch.cli.entry",
             "--dataset_name", "1798", "--dataset_path",
             os.path.join(tmp, "dataset"), *SAMPLING_ARGS,
             "--model_parallel", "halo", "--max_epochs", "1",
             "--default_root_dir", out],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"halo CLI: exit {proc.returncode}\n"
                                 f"{proc.stderr[-3000:]}")
        logs = os.path.join(out, "logs")
        tested = parse_test_result(os.path.join(logs, "test_result.log"))
        with open(os.path.join(logs, "task_info.log")) as f:
            info = f.read()
        launched = dict(
            (name, int(n)) for name, n in
            (part.split() for part in info.split("scorer_launches: ")[1]
             .splitlines()[0].split(", ")))
        steps = -(-sizes["train"] // 32)
        eval_batches = (-(-sizes["valid"] // 32)
                        + (len(tested) + 1) * -(-sizes["test"] // 32))
        want = 4 * (steps + eval_batches)
        with open(os.path.join(logs, "history.json")) as f:
            history = json.load(f)
        finite = all(np.isfinite(m[k]) for m in tested.values()
                     for k in ("AUC", "logAUC_0.001_0.1", "logAUC_0.001_1"))
        log(f"  halo CLI under torch.distributed.run --nproc_per_node 1 "
            f"(NCCL, --device_sampling --scan_steps 16, 1 epoch at batch "
            f"32) in {secs:.1f} s: {steps} steps, {eval_batches} "
            f"evaluation batches; scorer launches {launched} (want {want} "
            f"grouped); train loss {history[0]['train_loss']:.4f}; test "
            f"[last] AUC {tested['last']['AUC']:.4f}")
        if ("ranks: 1" not in info or not finite
                or not np.isfinite(history[0]["train_loss"])
                or not os.path.exists(os.path.join(
                    logs, "graph_embedding.npy"))):
            raise AssertionError(f"halo CLI artifacts: {info!r} {tested}")
        if launched["segment_sum"] <= 0 or scorer_launches(launched) != {
                "fused_support_score": 0, "grouped_support_score": want}:
            raise AssertionError(f"halo CLI launches {launched}")
        check_backward(launched, steps, "halo CLI")
        self.mp_launches["mp_cli"] = launched
        cards = self.torch.cuda.device_count()
        try:
            entry.main(["--model_parallel", "hybrid", "--num_devices",
                        str(cards + 1), "--dataset_name", "synthetic",
                        "--default_root_dir",
                        os.path.join(tmp, "cli_refused_mp")])
            message = None
        except SystemExit as e:
            message = str(e)
        log(f"  --model_parallel hybrid --num_devices {cards + 1} on "
            f"{cards} card(s): {message}")
        if not message or f"has {cards}" not in message or (
                f"{cards + 1} CUDA devices" not in message):
            raise AssertionError("the hybrid CLI was not refused naming "
                                 "both numbers")
        self.mp_record["cli"] = {"seconds": secs, "launches": launched,
                                 "test": tested, "refused": message}

    # ------------------------------------------------------------ phase 13
    def phase_last(self, graphs, tmp):
        """The last modules of the port (see the module doc): (a) the
        native graph utilities, (b) enantiomer_separation, (c) SphereNet's
        learned node vector, (d) the bf16 product option. Each main path
        counts the scorer's launches from 0."""
        t_phase = time.perf_counter()
        self.last_record, self.last_launches = {}, {}
        self.last_record["native"] = self.native_check(graphs)
        self.last_record["enantiomer_separation"] = self.separation_check()
        self.last_record["spherenet_node_vector"] = self.node_vector_check(
            graphs[:POINT_MOLECULES["spherenet"]], tmp)
        self.last_record["bf16"] = self.bf16_check(tmp)
        secs = time.perf_counter() - t_phase
        self.last_record["seconds"] = secs
        log(f"  phase 13 took {secs:.1f} s")

    def native_check(self, graphs):
        """(a) of phase 13: the g++ build and the native graph utilities
        against their numpy versions (host work; no device)."""
        import numpy as np

        from molkgnn_torch import native

        t0 = time.perf_counter()
        native.library()  # built on first use; raises if g++ fails
        build_s = time.perf_counter() - t0
        path = native.library_path()
        if not native.have_native() or not path.exists() or (
                path.parent != native.BUILD):
            raise AssertionError(f"the native library is not at {path}")
        mats = [graph_matrices(g) for g in graphs]

        def run(fw, ge, items, keep):
            kept = []
            t0 = time.perf_counter()
            for i, (adj, feat) in enumerate(items):
                dist, pred = fw(adj)
                out = ge(dist, pred, feat)
                if i < keep:
                    kept.append((dist, pred, out))
            return kept, (time.perf_counter() - t0) * 1e6 / len(items)

        lib_out, lib_ms = run(native.floyd_warshall, native.gen_edge_input,
                              mats, NATIVE_CHECKED)
        np_out, np_ms = run(native.floyd_warshall_numpy,
                            native.gen_edge_input_numpy,
                            mats[:NATIVE_CHECKED], NATIVE_CHECKED)
        for i, (a, b) in enumerate(zip(lib_out, np_out)):
            for x, y in zip(a, b):
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    raise AssertionError(
                        f"native against numpy differs at molecule {i}")
        log(f"  (a) native: g++ build and load {build_s:.3f} s into "
            f"{os.path.relpath(path)}; floyd_warshall + gen_edge_input on "
            f"the host: library {lib_ms:.1f} ms per 1,000 molecules "
            f"({len(mats)} of phase 3's), numpy {np_ms:.1f} ms per 1,000 "
            f"(the first {NATIVE_CHECKED}); equal bit for bit on those "
            f"{NATIVE_CHECKED}")
        return {"build_s": build_s, "library_ms_per_1000": lib_ms,
                "numpy_ms_per_1000": np_ms, "molecules": len(mats),
                "checked": NATIVE_CHECKED}

    def separation_check(self):
        """(b) of phase 13: enantiomer_separation on the card against the
        CPU, fp64 with the kernel off and fp32 on the grouped scorer."""
        import numpy as np

        from molkgnn_torch.analyses.embedding_compare import (
            enantiomer_separation,
        )
        from molkgnn_torch.data.synthetic import tie_free_molgraph
        from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs

        torch = self.torch
        rng = np.random.default_rng(SEED + 13)
        mols = []
        while len(mols) < ENANTIOMER_MOLECULES:
            g = tie_free_molgraph(rng)
            if has_chiral_centre(g):
                mols.append(g)
        spec = spec_for_graphs(mols, 1)
        pairs = [(f"m{i}", g) for i, g in enumerate(mols)]
        weights = self.flagship(4, True, seed=SEED + 13).state_dict()
        cos = {}
        for form, use_kernel in (("fp64", False), ("fp32", True)):
            model = self.flagship(4, use_kernel, seed=SEED + 13)
            model.load_state_dict(weights)
            enc = model.gnn_model.eval()
            if form == "fp64":
                enc = enc.double()
                one = lambda g: as_double(batch_graphs([g], spec))
            else:
                one = lambda g: batch_graphs([g], spec)
            cpu = enantiomer_separation(enc, one, pairs)
            reset_launches()
            card = enantiomer_separation(enc.cuda(), one, pairs)
            torch.cuda.synchronize()
            counts = launch_counts()
            if form == "fp32":
                self.last_launches["enantiomer"] = counts
            cos[form] = (np.array([cpu[n] for n, _ in pairs]),
                         np.array([card[n] for n, _ in pairs]), counts)
        d64 = float(np.abs(cos["fp64"][1] - cos["fp64"][0]).max())
        d32 = float(np.abs(cos["fp32"][1] - cos["fp32"][0]).max())
        card32, counts = cos["fp32"][1], cos["fp32"][2]
        want = 4 * 2 * len(pairs)
        log(f"  (b) enantiomer_separation, flagship width, {len(pairs)} "
            f"tie-free molecules with a chiral degree-4 centre: card against "
            f"CPU max |diff| fp64 (kernel off) {d64:.3e} (limit 1e-9), fp32 "
            f"(grouped scorer) {d32:.3e} (limit 1e-5); card fp32 cosines "
            f"min {card32.min():.6f}, median {np.median(card32):.6f} (fp64 "
            f"min {cos['fp64'][1].min():.6f}); scorer launches "
            f"{counts} (want {want} grouped, 4 a forward; fp64 route "
            f"{cos['fp64'][2]})")
        if d64 > 1e-9 or d32 > 1e-5:
            raise AssertionError("enantiomer_separation: the card disagrees")
        if not card32.min() < 0.99999:
            raise AssertionError("no mirror pair separates (cosine < 0.99999)")
        if scorer_launches(counts) != {"grouped_support_score": want,
                      "fused_support_score": 0} or any(
                          scorer_launches(cos["fp64"][2]).values()):
            raise AssertionError(f"enantiomer_separation launches {counts}")
        check_backward(counts, 0, "enantiomer_separation")
        return {"molecules": len(pairs), "fp64_max_diff": d64,
                "fp32_max_diff": d32, "min_cos": float(card32.min()),
                "median_cos": float(np.median(card32)), "launches": counts}

    def node_vector_check(self, mols, tmp):
        """(c) of phase 13: SphereNet(use_node_features=False) at its
        published widths: eager steps in turns with the atom-table model,
        fp64 card against CPU, a state_dict round trip."""
        import dataclasses
        import gc

        import numpy as np

        from molkgnn_torch.data.dataset import QSAR_METRICS, Dataset, _split
        from molkgnn_torch.graphs.geometric import batch_points
        from molkgnn_torch.models.registry import get_family
        from molkgnn_torch.training.checkpoint import from_torch_state_dict
        from molkgnn_torch.training.model import GNNModel
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        torch = self.torch
        name, key = "spherenet", "gnn_model.init_e.node_embedding.node_embedding"
        card = torch.cuda.get_device_name(0)
        family = get_family(name)
        mols = [dataclasses.replace(g) for g in mols]
        spec = family.make_spec(mols, SPHERE_BATCH)
        ds = Dataset(name, mols, _split(np.random.default_rng(SEED + 1),
                                        len(mols)),
                     list(QSAR_METRICS), "bce_with_logits")
        forms = {"node_vector": {"use_node_features": False},
                 "atom_table": {}}
        trainers = {
            form: Trainer(self.family_model(name, **opts), ds, spec,
                          TrainConfig(batch_size=SPHERE_BATCH, scan_steps=1,
                                      oversample=True, device_sampling=True,
                                      progress=False,
                                      log_dir=os.path.join(tmp, f"nv_{form}")),
                          device="cuda")
            for form, opts in forms.items()}
        vec0 = trainers["node_vector"].model.state_dict()[key].clone()
        for t in trainers.values():  # warm
            t._device_step()
        rates = {form: [] for form in trainers}
        losses = {form: [] for form in trainers}
        reset_launches()
        for form in ("node_vector", "atom_table", "atom_table",
                     "node_vector"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = [trainers[form]._device_step() for _ in range(3)]
            torch.cuda.synchronize()
            rates[form].append(3 * SPHERE_BATCH / (time.perf_counter() - t0))
            losses[form] += [float(x) for x in out]
        counts = launch_counts()
        self.last_launches["spherenet_node_vector"] = counts
        moved = float((trainers["node_vector"].model.state_dict()[key]
                       - vec0).abs().max())
        for form, r in rates.items():
            log(f"  (c) SphereNet {form}, batch {SPHERE_BATCH}, eager on "
                f"{card}: train {', '.join(f'{x:.1f}' for x in r)} graphs/s "
                f"(3 steps a run, synchronised once, in turns)")
        log(f"    node vector: first 3 losses {losses['node_vector'][:3]}; "
            f"the vector moved by up to {moved:.3e} in its 7 steps; scorer "
            f"launches {counts}")
        if not np.isfinite([x for v in losses.values() for x in v]).all():
            raise AssertionError("SphereNet node vector: a loss is not finite")
        check_backward(counts, 0, "SphereNet node vector (no scorer)")
        if not moved > 0 or any(scorer_launches(counts).values()):
            raise AssertionError(f"SphereNet node vector: the vector moved "
                                 f"{moved}, launches {counts}")
        trainers = None
        gc.collect()
        torch.cuda.empty_cache()

        spec8 = family.make_spec(mols[:8], 8)
        b8 = batch_points(mols[:8], spec8)
        b64 = dataclasses.replace(b8, pos=b8.pos.double(), y=b8.y.double())
        m64 = self.family_model(name, torch.float64,
                                use_node_features=False).eval()
        with torch.no_grad():
            want = m64(b64)[1].numpy()
            got = m64.cuda()(b64.to("cuda"))[1].cpu().numpy()
        scale = max(1.0, float(np.abs(want).max()))
        d64 = float(np.abs(got - want).max()) / scale

        model = self.family_model(name, use_node_features=False)
        sd = model.state_dict()
        ref = {"model." + k: v.clone() for k, v in sd.items()}
        gen = torch.Generator().manual_seed(SEED + 1)
        other = GNNModel(family.make_encoder(generator=gen,
                                             use_node_features=False),
                         generator=gen)
        before = torch.equal(other.state_dict()[key], sd[key])
        other.load_state_dict(from_torch_state_dict(other, ref,
                                                    prefix="model."),
                              strict=True)
        round_trip = (not before and key in sd and set(other.state_dict())
                      == set(sd) and all(torch.equal(v, sd[k]) for k, v in
                                         other.state_dict().items())
                      and not any(k.startswith("gnn_model.init_e.emb")
                                  for k in sd))
        log(f"    8 molecules, fp64 card against CPU {d64:.3e} (relative to "
            f"max |value| {scale:.3e}; limit 1e-9); state_dict through "
            f"from_torch_state_dict into a model of another seed: "
            f"{'equal' if round_trip else 'DIFFERENT'} ({len(sd)} keys, "
            f"{key} included)")
        if d64 > 1e-9 or not round_trip:
            raise AssertionError("SphereNet node vector: card or bridge fails")
        return {"graphs_per_s": rates, "losses": losses["node_vector"],
                "vector_moved": moved, "fp64_rel_diff": d64,
                "launches": counts}

    def bf16_check(self, tmp):
        """(d) of phase 13: the flagship's bf16 products at batch 1024 on
        the card against the CPU on both routes, and replayed train
        graphs/s against fp32."""
        import numpy as np

        from molkgnn_torch.data.dataset import make_tie_free_dataset
        from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        torch = self.torch
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on: cuBLAS would round the fp32 "
                                 "products")
        bf16 = torch.bfloat16
        ds = getattr(self, "tie_free_data", None) or make_tie_free_dataset(
            NUM_MOLECULES, NUM_MOLECULES * 3 // 4, seed=SEED)
        spec = spec_for_graphs(ds.graphs, BATCH)
        batch = batch_graphs(ds.graphs[:BATCH], spec)
        dev = batch.to("cuda")
        rec = {}
        for route, use_kernel in (("kernel", True), ("plain", False)):
            model = self.flagship(4, use_kernel, seed=SEED + 14, dropout=0.0,
                                  matmul_dtype=bf16).eval()
            with torch.no_grad():
                want = [t.numpy() for t in model(batch)]
                model.cuda()
                reset_launches()
                got = [t.cpu().numpy() for t in model(dev)]
                counts = launch_counts()
                model.gnn_model.gnn.layers.apply(
                    lambda m: setattr(m, "matmul_dtype", None))
                full = [t.cpu().numpy() for t in model(dev)]
            diff = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
            gap = max(float(np.abs(f - g).max()) for f, g in zip(full, got))
            tol = 1e-5 if use_kernel else 1e-4
            close = all(np.allclose(g, w, rtol=tol, atol=tol)
                        for g, w in zip(got, want))
            log(f"  (d) bf16 products, flagship at batch {BATCH}, {route} "
                f"route: card against CPU max |diff| {diff:.3e} (within "
                f"{tol:g}: {close}); against the card's fp32 products "
                f"{gap:.3e} (want > 1e-4); scorer launches {counts}")
            want_launches = {"grouped_support_score": 4 if use_kernel else 0,
                             "fused_support_score": 0}
            if not close or gap <= 1e-4 or scorer_launches(counts) != want_launches:
                raise AssertionError(f"bf16 {route} route fails")
            if use_kernel:
                self.last_launches["bf16_eval"] = counts
            rec[route] = {"max_diff": diff, "fp32_gap": gap,
                          "launches": counts}
        trainers = {}
        for form, opts in (("bf16", {"matmul_dtype": bf16}), ("fp32", {})):
            model = self.flagship(4, True, seed=SEED + 14, dropout=0.0,
                                  **opts)
            trainers[form] = (Trainer(
                model, ds, spec, TrainConfig(
                    batch_size=BATCH, progress=False, scan_steps=16,
                    device_sampling=True,
                    log_dir=os.path.join(tmp, f"bf16_{form}")),
                device="cuda"), 4)
        rec["train_graphs_per_s"] = self.epoch_rates(
            trainers, ("bf16", "fp32", "fp32", "bf16"),
            f"(d) replayed flagship b{BATCH}, device sampling,")
        return rec

    # ------------------------------------------------------------ record
    # ------------------------------------------------------------ phase 14
    def phase_repeat(self, graphs, spec):
        """The fixed-order segment sum (ops/segment.py, csrc/segment_sum.cu)
        and the repeatability it gives, with the checks of the module doc:
        (a) the kernel bit-equal to its plain version at the flagship's
        cover shapes, timed; (b) the flagship on phase 3's molecules (ties
        included) forward, screening, eager and replayed steps; (c) the
        point families and ChIRoNet; (d) no index_add_ kernel in a profiled
        replayed step."""
        t_phase = time.perf_counter()
        self.repeat_record = {}
        self.segment_kernel_times(graphs, spec)
        self.repeat_flagship(graphs, spec)
        self.repeat_families()
        self.replay_kernel_names()
        secs = time.perf_counter() - t_phase
        self.repeat_record["seconds"] = secs
        log(f"  phase 14 took {secs:.1f} s")

    def segment_kernel_times(self, graphs, spec):
        """(a): the main path's segment sums and their plans on one
        flagship batch of 1024 of phase 3's molecules, five cases, fp32 and
        fp64 (``molkgnn_torch/tools/segment_times.py``): the sum bit-equal
        to its plain version on CPU copies and the plan kernel's plan equal
        to the plain plan (else the phase fails); device ms of both
        (torch.profiler) beside their event ms, the byte bounds,
        index_add_, torch.sort and the plain versions."""
        from molkgnn_torch.graphs.batch import batch_graphs
        from molkgnn_torch.tools.segment_times import measure

        b = batch_graphs(graphs[:BATCH], spec).to("cuda")
        record = measure(b, SEED, log)
        self.repeat_record["kernel"] = record
        self.segment_times = record["message passing, float32"]

    def repeat_flagship(self, graphs, spec):
        """(b): the flagship on phase 3's molecules, ties included: three
        forwards bit-equal; screen_library against predict_graphs; two
        eager epochs and two replayed epochs from one state, each pair
        bit-equal, eager against replayed within 1e-5; launches counted."""
        import numpy as np

        from molkgnn_torch.graphs.batch import batch_graphs
        from molkgnn_torch.ops import segment as sg
        from molkgnn_torch.serving.predictor import Predictor
        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        torch = self.torch
        rec = {}
        model = self.flagship(4, True).cuda().eval()
        batch = batch_graphs(graphs[:BATCH], spec).to("cuda")
        reset_launches()
        with torch.inference_mode():
            outs = [model(batch) for _ in range(3)]
        launched = sg.segment_sum.launches
        plans = sg.segment_plan.launches
        same = all(torch.equal(o[k], outs[0][k]) for o in outs
                   for k in range(2))
        log(f"  (b) three flagship forwards on {BATCH} of phase 3's "
            f"molecules: bit-equal {same}; segment-sum launches {launched} "
            f"(5 a forward: 4 layers' message passing and the pooling), "
            f"plans {plans} (2 a forward: the edges' and the pooling's)")
        if not same or launched != 15 or plans != 6:
            raise AssertionError("flagship forwards differ or the segment "
                                 f"sum launched {launched} times, want 15, "
                                 f"or {plans} plans were built, want 6")
        rec["forwards_bit_equal"] = same

        sd = {k: v.clone() for k, v in model.state_dict().items()}
        pred = Predictor(model, sd, spec, device="cuda")
        mols = graphs[:NUM_MOLECULES]
        direct = np.asarray(pred.predict_graphs(mols))
        screened = np.asarray(pred.screen_library(mols))
        gap = float(np.abs(direct - screened).max())
        log(f"  (b) screen_library against predict_graphs on "
            f"{len(mols)} molecules: largest gap {gap!r} (0 expected: a "
            f"molecule's sums no longer depend on its batch-mates or the "
            f"run, and both paths fill the same batches)")
        rec["screen_vs_predict_max_gap"] = gap

        ds, tspec = self.train_data  # phase 5's: phase 3's molecules
        runs = {}
        for name, k in (("eager", 1), ("eager", 1), ("replayed", 8),
                        ("replayed", 8)):
            trainer = Trainer(self.flagship(4, True, seed=SEED + 2,
                                            dropout=0.25),
                              ds, tspec, TrainConfig(
                                  batch_size=BATCH, scan_steps=k,
                                  progress=False))
            reset_launches()
            losses = torch.stack(trainer._epoch_steps()).cpu()
            if k > 1 and trainer._graph is None:
                raise AssertionError("scan_steps=8 captured no graph")
            state = {key: v.detach().clone()
                     for key, v in trainer.model.state_dict().items()}
            counts = launch_counts()
            check_backward(counts, len(losses), f"(b) {name} epoch")
            runs.setdefault(name, []).append(
                (losses, state, counts["segment_sum"],
                 counts["grouped_support_score"], counts["segment_plan"]))
        for name, pair in runs.items():
            (l0, s0, n0, g0, p0), (l1, s1, n1, g1, p1) = pair
            equal = torch.equal(l0, l1) and all(
                torch.equal(v, s1[key]) for key, v in s0.items())
            steps = len(l0)
            log(f"  (b) two {name} epochs of {steps} steps at batch "
                f"{BATCH} (dropout 0.25) from one state: bit-equal {equal}; "
                f"segment-sum launches {n0}, {n1} (73 a step); plans {p0}, "
                f"{p1} (11 a step); scorer {g0}, {g1}")
            if not equal:
                raise AssertionError(f"two {name} epochs differ")
            if {n0, n1} != {73 * steps} or {p0, p1} != {11 * steps}:
                raise AssertionError(f"{name} epochs: segment sums {n0}, "
                                     f"{n1} or plans {p0}, {p1} are not 73 "
                                     "and 11 a step")
            rec[f"{name}_bit_equal"] = equal
            rec[f"{name}_segment_launches"] = n0
            rec[f"{name}_plan_launches"] = p0
        (le, se, *_), (lr, sr, *_) = runs["eager"][0], runs["replayed"][0]
        rel = float(((lr - le).abs() / le.abs()).max())
        diff = max(float((v - sr[key]).abs().max()) for key, v in se.items()
                   if v.is_floating_point())
        log(f"  (b) eager against replayed on phase 3's molecules: losses "
            f"max relative difference {rel:.3e}, parameters {diff:.3e} "
            f"(limit 1e-5; 3.595e-4 here when index_add_ summed)")
        if rel > 1e-5 or diff > 1e-5:
            raise AssertionError("eager and replayed epochs differ > 1e-5")
        rec.update(eager_vs_replayed_rel_loss=rel,
                   eager_vs_replayed_param=diff)
        self.repeat_record["flagship"] = rec
        self.repeat_launches = runs["replayed"][0][2]
        self.repeat_plans = runs["replayed"][0][4]

    def repeat_families(self):
        """(c): each point family and ChIRoNet at its phase 8 or 9 batch,
        one batch of its molecules: forward and backward twice, the
        predictions and every gradient bit-equal."""
        import gc

        from molkgnn_torch.graphs.chiro import batch_chiro
        from molkgnn_torch.graphs.geometric import batch_points
        from molkgnn_torch.ops import segment as sg
        from molkgnn_torch.training.model import bce_with_logits_loss

        torch = self.torch
        rec = {}
        for name, (mols, spec) in self.family_batches.items():
            pack = batch_chiro if name == "chironet" else batch_points
            B = spec.num_graphs
            batch = pack(mols[:B], spec).to("cuda")
            model = self.family_model(name).cuda().eval()
            runs = []
            reset_launches()
            for _ in range(2):
                model.zero_grad(set_to_none=True)
                out, _ = model(batch)
                bce_with_logits_loss(out, batch.y, batch.graph_mask).backward()
                runs.append([out.detach().clone()] + [
                    p.grad.clone() for p in model.parameters()
                    if p.grad is not None])
            launched = sg.segment_sum.launches
            plans = sg.segment_plan.launches
            equal = all(torch.equal(a, b) for a, b in zip(*runs))
            log(f"  (c) {name}, batch {B}: forward and backward twice, "
                f"prediction and {len(runs[0]) - 1} gradients bit-equal "
                f"{equal}; segment-sum launches {launched}, plans {plans}")
            if not equal or not launched or not plans:
                raise AssertionError(f"{name}: two forward and backward "
                                     "passes differ")
            rec[name] = {"batch": B, "bit_equal": equal,
                         "segment_launches": launched,
                         "plan_launches": plans}
            batch = model = runs = None
            gc.collect()
            torch.cuda.empty_cache()
        self.repeat_record["families"] = rec

    def replay_kernel_names(self):
        """(d): the kernels of two profiled replays of the flagship's
        captured step (batch 1024, device sampling): none of index_add_'s,
        index_put_'s sorting backward or scatter_add's, the float atomics
        of the sums the segment-sum kernel replaces."""
        from torch.profiler import ProfilerActivity, profile

        from molkgnn_torch.training.trainer import TrainConfig, Trainer

        torch = self.torch
        ds, tspec = self.train_data
        trainer = Trainer(self.flagship(4, True), ds, tspec, TrainConfig(
            batch_size=BATCH, progress=False, scan_steps=16,
            device_sampling=True))
        for _ in range(4):
            trainer._graph_step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                trainer._graph_step()
            torch.cuda.synchronize()
        rows = sorted(device_rows(prof), reverse=True)
        if not rows:
            raise AssertionError("the profiler recorded no kernel of the "
                                 "replayed step")
        log(f"  (d) kernels of 2 profiled replays of the flagship step "
            f"({len(rows)} kernels, device ms, count, name):")
        for ms, count, key in rows:
            log(f"    {ms:9.3f} ms  x{count:<5d} {key[:110]}")
        bad = [key for _, _, key in rows
               if any(p in key for p in ATOMIC_SUMS)]
        if bad:
            raise AssertionError(f"atomic sums in the replayed step: {bad}")
        # The plans' library sorts (the parent's 11 stable radix sorts a
        # step, 110 kernels) and their 11 searchsorted: the plan kernel
        # replaces both; device sampling's 6 searchsorted a step stay (one a
        # gathered field: graphs/device_pack.py::_ranged_gather).
        sorts = sum(count for _, count, key in rows
                    if "sort" in key.lower() and "searchsorted" not in key)
        searches = sum(count for _, count, key in rows
                       if "searchsorted" in key)
        plan_ms = sum(ms for ms, _, key in rows if "plan_" in key)
        log(f"  (d) sort kernels {sorts}, searchsorted kernels {searches} "
            f"(device sampling's, 6 a step), plan kernels "
            f"{plan_ms / 2:.4f} ms a step")
        if sorts or searches > 2 * 6:
            raise AssertionError("the plans' library sorts or searchsorted "
                                 "are in the replayed step")
        backward = [(ms, count, key) for ms, count, key in rows
                    if BACKWARD_NAME in key]
        launched = sum(count for _, count, _ in backward) / 2
        backward_ms = sum(ms for ms, _, _ in backward) / 2
        log(f"  (d) the scorer backward's kernels {backward_ms:.4f} ms a "
            f"step, {launched:g} launches a step (4 calls of up to 3 "
            f"kernels)")
        if not backward:
            raise AssertionError("the scorer backward's kernels are not in "
                                 "the replayed step")
        self.repeat_record["replay_backward_ms_a_step"] = backward_ms
        self.repeat_record["replay_kernels"] = [
            {"ms": ms, "count": count, "name": key} for ms, count, key in rows]
        self.repeat_record["replay_sorts"] = sorts
        self.repeat_record["replay_searchsorted"] = searches
        self.repeat_record["replay_plan_ms_a_step"] = plan_ms / 2

    def kernel_record(self):
        entries = []
        launches = {
            "grouped_support_score": self.main_launches[
                "grouped_support_score"
            ],
            "fused_support_score": self.conv_launches,
        }
        paths = {
            "grouped_support_score": "serving: Predictor.predict_graphs, "
            "per request 1 launch at layer 0 + 3 at N-hop layers",
            "fused_support_score": "KernelConv(use_kernel=True), one "
            "launch per degree bucket at layer-0 shapes",
        }
        train_paths = {
            "grouped_support_score": "training: Trainer.fit + test, 4 "
            "launches per optimizer step and per evaluation batch",
            "fused_support_score": "not on the training path",
        }
        cli_paths = {
            "grouped_support_score": "CLI: molkgnn_torch.cli.entry.main, "
            "flagship on AID-1798 SDF files, --device_sampling --scan_steps "
            "16, 4 launches per step (graph replays) and per evaluation "
            "batch",
            "fused_support_score": "not on the CLI's path",
        }
        new_paths = {
            "screen": (self.screen_launches, "Predictor.screen_library, "
                       "131,072 molecules at batch 1024 in two slabs, one "
                       "CUDA graph replayed per block, 4 a block"),
            "export": (self.export_launches, "the exported program "
                       "(torch.ops.molkgnn.support_score nodes) run by "
                       "molkgnn_torch.cli.screen, 4 a batch"),
            "eval": (self.eval_launches, "captured evaluation: "
                     "Trainer._predict_ids through serving.blocks."
                     "BlockScorer, 194 batches of 32, 4 a batch"),
        }
        for path, counts in self.points_launches.items():
            new_paths[f"points_{path}"] = (
                counts, f"phase 8, {path}: not on the point families' "
                "path (0, counted)")
        for path, counts in self.chiro_launches.items():
            new_paths[f"chironet_{path}"] = (
                counts, f"phase 9, {path}: not on ChIRoNet's path (0, "
                "counted)")
        side_paths = {
            "balanced": "phase 10(a): Trainer.fit with balanced_batches "
            "under the dealt tight spec, 2 epochs replayed (scan_steps=16), "
            "4 a step and 4 an evaluation batch",
            "fixed": "phase 10(b): the flagship with fixed kernel sets, 3 "
            "train steps and an evaluation, 4 a step and a batch (layer 0 "
            "one launch of 8 groups)",
            "balanced_cli": "phase 10(c): molkgnn_torch.cli.entry "
            "--balanced_batches --scan_steps 16 on phase 6's SDF pair, 4 a "
            "step and an evaluation batch",
        }
        for path, what in side_paths.items():
            new_paths[path] = (self.side_launches[path], what)
        dp_paths = {
            "dp_world1": "phase 11(a): Trainer(mesh=make_mesh(1)) on host "
            "ids, scan_steps=16, the NCCL all-reduce inside the captured "
            "step, an epoch, 4 a step",
            "dp_sampling": "phase 11(a): the same with device_sampling, an "
            "epoch, 4 a step",
            "dp_screen": "phase 11(c): Predictor.screen_library(mesh="
            "make_mesh(1)), 131,072 molecules, 4 a block",
            "dp_eval": "phase 11(c): DP evaluation at world 1 "
            "(Trainer._predict_ids), 4 a block",
            "dp_two_ranks": "phase 11(b): rank 0 of 2 gloo ranks on one "
            "card, its 2 of 4 evaluation blocks and 3 eager steps, 4 each",
            "dp_cli": "phase 11(d): molkgnn_torch.cli.entry under "
            "torch.distributed.run --nproc_per_node 1, read from its "
            "task_info.log, 4 a step and an evaluation batch",
        }
        for path, what in dp_paths.items():
            new_paths[path] = (self.dp_launches[path], what)
        mp_paths = {
            "mp_world1": "phase 12(a): Trainer(model_parallel='halo', "
            "mesh=make_mesh(1)) with device sampling, scan_steps=16, the "
            "exchanges inside the captured step, an epoch, 4 a step",
            "mp_host": "phase 12(a): the host-fed halo epoch at world 1, "
            "eager, 4 a step",
            "mp_four_ranks": "phase 12(b): rank 0 of 4 gloo ranks on one "
            "card: a halo eval forward, 3 halo steps, a hybrid 2x2 step and "
            "an edge-partition forward, 4 each",
            "mp_cli": "phase 12(c): molkgnn_torch.cli.entry --model_parallel"
            " halo under torch.distributed.run --nproc_per_node 1, read from"
            " its task_info.log, 4 a step and an evaluation batch",
        }
        for path, what in mp_paths.items():
            new_paths[path] = (self.mp_launches[path], what)
        last_paths = {
            "enantiomer": "phase 13(b): enantiomer_separation at the "
            "flagship's width, fp32, 64 molecules and their mirror images "
            "one at a time, 4 a forward",
            "spherenet_node_vector": "phase 13(c): SphereNet(use_node_"
            "features=False) eager train steps: not on its path (0, "
            "counted)",
            "bf16_eval": "phase 13(d): the flagship with matmul_dtype="
            "torch.bfloat16, an eval forward at batch 1024, 4",
        }
        for path, what in last_paths.items():
            new_paths[path] = (self.last_launches[path], what)
        for name in ("grouped_support_score", "fused_support_score"):
            if name == "grouped_support_score":
                (l0, s0, e0) = self.per_request[(name, "layer 0")]
                (ln, sn, en) = self.per_request[(name, "N-hop layer")]
                ms = [total([l0[i], ln[i], ln[i], ln[i]]) for i in range(4)]
                shapes = s0 + sn * 3
                err = max(e0, en)
            else:
                (t, shapes, err) = self.per_request[(name, "layer 0")]
                ms = list(t)
            b_ms, by = bound_ms(shapes)
            entries.append({
                "name": name,
                "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": REPLACES[name],
                "launches": launches[name],
                "max_abs_err": err,
                "ms": ms[0],
                "plain_ms": ms[1],
                "bound_ms": b_ms,
                "bound_by": by,
                "library_ms": ms[2],
                "device_ms": ms[3],
                "path": paths[name],
                "train_launches": self.train_launches[name],
                "train_path": train_paths[name],
                "cli_launches": self.cli_launches[name],
                "cli_path": cli_paths[name],
            })
            for path, (counts, what) in new_paths.items():
                grouped = name == "grouped_support_score"
                entries[-1][f"{path}_launches"] = counts[name]
                entries[-1][f"{path}_path"] = (
                    what if grouped else "not on this path")
            if name == "grouped_support_score":
                entries[-1]["backward_ms_per_step"] = self.backward_step_ms
                entries[-1]["op_dispatch_ms"] = self.op_dispatch
                t8, shapes8, err8, t4, graph = self.fixed_times
                b8, by8 = bound_ms(shapes8)
                entries[-1].update({
                    "fixed_layer0_8_groups": {
                        "shapes": shapes8, "max_abs_err": err8,
                        "ms": t8[0], "plain_ms": t8[1], "library_ms": t8[2],
                        "device_ms": min(graph[8]),
                        "profiler_device_ms": t8[3], "bound_ms": b8,
                        "bound_by": by8,
                    },
                    "fixed_layer0_4_trainable_groups": {
                        "ms": t4[0], "plain_ms": t4[1], "library_ms": t4[2],
                        "device_ms": min(graph[4]),
                        "profiler_device_ms": t4[3],
                        "bound_ms": bound_ms(shapes8[1::2])[0],
                    },
                })
        entries.append(self.backward_record(new_paths))
        entries.append(self.segment_record(new_paths))
        entries.append(self.plan_record(new_paths))
        return {"kernels": entries}

    def backward_record(self, new_paths):
        """The scorer backward's entry of the kernel record: phase 5's
        times a flagship train step (layer 0 + 3 N-hop layers; events, the
        profiler's device time of its kernels, the byte bound, the dense
        plain route), its largest difference from the plain version there,
        and its launches on the main training path (fit + test), each path
        counted from 0. No one PyTorch call computes it: library_ms is null
        and the dense route (the plain version) is its yardstick."""
        t = self.backward_step
        return {
            "name": "support_score_backward",
            "route": "cuda",
            "source": BACKWARD_SOURCE,
            "replaces": BACKWARD_REPLACES,
            "launches": self.train_backward_launches,
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "device_ms": t["device_ms"],
            "plain_device_ms": t["plain_device_ms"],
            "per_layer": self.backward_ms,
            "path": "training: Trainer.fit + test, 4 a train step (one a "
            "layer), none for an evaluation batch; times a train step",
            "path_launches": self.path_counts(new_paths,
                                              "support_score_backward"),
        }

    def path_counts(self, new_paths, name):
        """``name``'s launches on the CLI's path and every path of
        ``new_paths``, each counted from 0; paths that counted none are
        printed."""
        paths = {"cli": self.cli_launches[name]}
        for path, (counts, _) in new_paths.items():
            paths[path] = counts[name]
        zeros = [k for k, n in paths.items() if not n]
        log(f"  {name} launches on every counted path: {paths}")
        if zeros:
            log(f"  paths that counted no {name} launch: {zeros}")
        return paths

    def shapes(self):
        return {k: {f: v[f] for f in ("segments", "terms", "ids",
                                      "rows_read", "width")}
                for k, v in self.repeat_record["kernel"].items()}

    def segment_record(self, new_paths):
        """The segment sum's entry of the kernel record: phase 14(a)'s
        times of the message passing's sum (fp32), and its launches on the
        main paths (serving, training, phase 14(b)'s replayed epoch), each
        counted from 0, beside the count of the CLI and every path of
        ``new_paths``."""
        t = self.segment_times
        return {
            "name": "segment_sum",
            "route": "cuda",
            "source": SEGMENT_SOURCE,
            "replaces": SEGMENT_REPLACES,
            "launches": self.main_segment_launches,
            "max_abs_err": t["max_abs_err"],
            "ms": t["kernel_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["index_add_ms"],
            "device_ms": t["kernel_device_ms"],
            "plan_ms": t["plan_ms"],
            "path": "serving: Predictor.predict_graphs, 5 a request (4 "
            "layers' message passing and the pooling)",
            "train_launches": self.train_segment_launches,
            "train_path": "training: Trainer.fit + test, 73 a step, 5 an "
            "evaluation batch",
            "replayed_epoch_launches": self.repeat_launches,
            "shapes": self.shapes(),
            "path_launches": self.path_counts(new_paths, "segment_sum"),
        }

    def plan_record(self, new_paths):
        """The plan builder's entry of the kernel record: phase 14(a)'s
        times of the message passing's plan (its event and device ms, the
        plain chain's, the byte bound; no single library call builds a
        plan, so library_ms is null and torch.sort of its keys stands
        beside it), and its plans on every path, counted as the sum's."""
        t = self.segment_times
        return {
            "name": "segment_plan",
            "route": "cuda",
            "source": PLAN_SOURCE,
            "replaces": PLAN_REPLACES,
            "launches": self.main_plan_launches,
            "max_abs_err": 0,
            "ms": t["plan_ms"],
            "plain_ms": t["plan_plain_ms"],
            "bound_ms": t["plan_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "device_ms": t["plan_device_ms"],
            "sort_ms": t["sort_ms"],
            "path": "serving: Predictor.predict_graphs, 2 a request (the "
            "edges' plan and the pooling's), one count a plan",
            "train_launches": self.train_plan_launches,
            "train_path": "training: Trainer.fit + test, 11 a step, 2 an "
            "evaluation batch",
            "replayed_epoch_launches": self.repeat_plans,
            "shapes": self.shapes(),
            "path_launches": self.path_counts(new_paths, "segment_plan"),
        }


def _dp_rank(path):
    """A rank of phase 11(b), started by molkgnn_torch.parallel.launch in a
    gloo world of 2 on one card: gloo's collectives on CUDA tensors, the
    world-2 evaluation, 3 eager DP steps; rank 0 writes its results."""
    import pickle

    import torch
    import torch.distributed as dist

    from molkgnn_torch.parallel.data_parallel import make_mesh

    mesh = make_mesh(2, backend="gloo")
    rank = dist.get_rank()
    t = torch.full((4,), float(rank + 1), device="cuda")
    dist.all_reduce(t)
    parts = [torch.empty(4, device="cuda") for _ in range(2)]
    dist.all_gather(parts, t)
    gloo = (t.tolist() == [3.0] * 4
            and [p.tolist() for p in parts] == [[3.0] * 4] * 2)
    if not gloo:
        raise AssertionError(f"gloo on CUDA tensors: {t} {parts}")
    with open(os.path.join(path, "job.pkl"), "rb") as f:
        ds, job = pickle.load(f)
    smoke = Smoke(torch)
    trainer = smoke.dp_trainer(ds, mesh)
    reset_launches()
    _, pred = trainer._predict_ids(job["eval"])
    losses, step_ms = [], []
    for step in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = job["ids"][step, rank]
        losses.append(float(trainer._step_ids(ids)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if rank == 0:
        with open(os.path.join(path, "rank0.pkl"), "wb") as f:
            pickle.dump({
                "gloo": gloo, "eval": pred, "losses": losses,
                "step_ms": step_ms, "launches": launch_counts(),
                "state": {k: v.cpu() for k, v in
                          trainer.model.state_dict().items()},
            }, f)


def exchange_ms(torch, hp, group, world, reps=20):
    """Host-clock ms of one halo exchange (``parallel/collectives.py``) of
    a layer's scores, ``[world, hp, sum(L)]`` fp32 on the card, over
    ``group``, synchronised; the mean over ``reps`` after 3."""
    from molkgnn_torch.parallel.collectives import exchange

    send = torch.zeros((world, hp, sum(FLAGSHIP_KERNELS)), device="cuda")
    for _ in range(3):
        exchange(send, group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        exchange(send, group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _mp_rank(path):
    """A rank of phase 12(b), started by molkgnn_torch.parallel.launch in
    a gloo world of 4 on one card: halo at 4 shards (the eval forward, the
    first step's gradients, 3 steps), a 2x2 hybrid step and the edge
    partition's forward; rank 0 writes its results."""
    import pickle

    import torch
    import torch.distributed as dist

    from molkgnn_torch.graphs.batch import batch_graphs
    from molkgnn_torch.models.kgnn import MolKGNNNet
    from molkgnn_torch.parallel import edge_partition
    from molkgnn_torch.parallel.data_parallel import make_mesh
    from molkgnn_torch.parallel.halo import halo_stats, model_forward
    from molkgnn_torch.parallel.hybrid import make_mesh_2d
    from molkgnn_torch.training.optim import fill_missing_grads

    mesh = make_mesh(4, backend="gloo")
    mesh2 = make_mesh_2d(2, 2, backend="gloo")
    rank = dist.get_rank()
    with open(os.path.join(path, "job.pkl"), "rb") as f:
        ds, job = pickle.load(f)
    smoke = Smoke(torch)
    halo = smoke.mp_trainer(ds, mesh, model_parallel="halo")
    batches = [batch_graphs([ds.graphs[i] for i in row], halo.spec)
               for row in job["halo"]]
    parts = [halo._partition([b]) for b in batches]
    out, launches = {"stats": halo_stats(parts[0])}, {}

    def counted(name, fn):
        reset_launches()
        result = fn()
        torch.cuda.synchronize()
        launches[name] = launch_counts()
        return result

    with torch.no_grad():
        out["eval"] = counted("eval", lambda: model_forward(
            halo.model, halo._mine(parts[0]), halo._mp, train=False)[0]
            .cpu())

    def snapshot():
        return {n: p.grad.detach().cpu().clone()
                for n, p in halo.model.named_parameters()}

    def state():
        return {k: v.detach().cpu().clone()
                for k, v in halo.model.state_dict().items()}

    def steps():
        out["states"] = [state()]  # the state before each step
        loss = halo._loss(halo._mine(parts[0]))
        loss.backward()
        fill_missing_grads(halo._params)
        halo._sync(loss.detach())
        out["grads"] = [snapshot()]
        halo._update()
        out["states"].append(state())
        out["step_ms"] = []
        for i, part in enumerate(parts[1:]):
            if i:
                out["states"].append(state())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            halo._step(halo._mine(part))
            torch.cuda.synchronize()
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["grads"].append(snapshot())

    counted("halo", steps)
    out["halo"] = {k: v.cpu() for k, v in halo.model.state_dict().items()}
    out["exchange_ms"] = exchange_ms(
        torch, parts[0].halo_per_pair, mesh.get_group("data"), 4)
    hybrid = smoke.mp_trainer(ds, mesh2, model_parallel="hybrid",
                              tot_iterations=MP_ITERATIONS)
    groups = [batch_graphs([ds.graphs[i] for i in row], hybrid.spec)
              for row in job["hybrid"]]
    counted("hybrid", lambda: hybrid._step(
        hybrid._mine(hybrid._partition(groups))))
    out["hybrid"] = {k: v.cpu() for k, v in hybrid.model.state_dict().items()}
    enc = smoke.flagship(4, True, seed=SEED + 12, dropout=0.0).gnn_model
    edge = MolKGNNNet(use_kernel=True, psum_group=mesh.get_group("data"))
    edge.load_state_dict(enc.state_dict())
    forward = edge_partition.edge_parallel_forward(edge.cuda(), mesh)
    out["edge"] = counted("edge", lambda: forward(
        edge_partition.partition_batch(batches[0], 4)).cpu())
    out["launches"] = launches
    if rank == 0:
        with open(os.path.join(path, "rank0.pkl"), "wb") as f:
            pickle.dump(out, f)


def main() -> int:
    import faulthandler

    import torch

    faulthandler.enable()  # a crash in native code prints the Python stack

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import molkgnn_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: molkgnn_torch not found; run this from the root "
              "of a checkout of the repository", file=sys.stderr)
        return 1
    from molkgnn_torch.data.synthetic import random_dataset
    from molkgnn_torch.graphs.batch import spec_for_graphs
    from molkgnn_torch.ops import _build

    smoke = Smoke(torch)
    smi = None
    phase = "device"
    try:
        log("[1] device")
        smi = nvidia_smi_line()
        log(f"  {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        phase = "build"
        log("[2] build")
        secs = _build.build_all()
        log(f"  built in {secs:.2f} s")
        from molkgnn_torch.ops.support_score import kernel_facts

        for facts in kernel_facts():
            log("  support_score tile " + ", ".join(
                f"{k} {v}" for k, v in facts.items()
            ))
        from molkgnn_torch.ops.support_score import backward_facts

        for kernel, facts in backward_facts().items():
            log(f"  support_score backward {kernel}: " + ", ".join(
                f"{k} {v}" for k, v in facts.items()))

        phase = "kernels"
        log("[3] kernels against their plain versions")
        t0 = time.perf_counter()
        graphs = random_dataset(seed=SEED, num_graphs=NUM_MOLECULES)
        spec = spec_for_graphs(graphs, BATCH)
        log(f"  {NUM_MOLECULES} synthetic molecules in "
            f"{time.perf_counter() - t0:.1f} s; spec {spec}")
        smoke.phase_kernels(spec)

        phase = "serve"
        log("[4] serving path")
        smoke.phase_serve(graphs, spec)

        phase = "train"
        log("[5] training path")
        smoke.phase_train(spec)

        with tempfile.TemporaryDirectory() as tmp:
            phase = "cli"
            log("[6] the CLI on an AID-1798 SDF pair")
            smoke.phase_cli(tmp)
            phase = "screen"
            log("[7] screening, import and export")
            smoke.phase_screen(graphs, spec, tmp)
            phase = "points"
            log("[8] the point families: SchNet, DimeNet++, SphereNet")
            smoke.phase_points(graphs, tmp)
            phase = "chironet"
            log("[9] ChIRoNet")
            smoke.phase_chiro(tmp)
            phase = "side"
            log("[10] balanced batches, fixed kernel sets, monitors, sweeps")
            smoke.phase_side(tmp)
            phase = "data parallel"
            log("[11] data parallel on torch.distributed")
            smoke.phase_dp(graphs, spec, tmp)
            phase = "model parallel"
            log("[12] model parallel on torch.distributed")
            smoke.phase_mp(tmp)
            phase = "last modules"
            log("[13] native utilities, enantiomer_separation, SphereNet's "
                "node vector, bf16 products")
            smoke.phase_last(graphs, tmp)
            phase = "repeatability"
            log("[14] the fixed-order segment sum: kernel against plain, "
                "repeatable results on the card")
            smoke.phase_repeat(graphs, spec)
        record = smoke.kernel_record()
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' failed", file=sys.stderr)
        return 1

    print(json.dumps({"throughput": smoke.throughput,
                      "train_throughput": smoke.train_throughput_record,
                      "train_step_profile_ms": smoke.step_profile,
                      "graphed_vs_eager": smoke.graphed_vs_eager_record,
                      "graphed": smoke.graphed_record,
                      "cli": smoke.cli_record,
                      "screen": smoke.screen_record,
                      "evaluation": smoke.eval_record,
                      "points": smoke.points_record,
                      "chironet": smoke.chiro_record,
                      "side": smoke.side_record,
                      "data_parallel": smoke.dp_record,
                      "model_parallel": smoke.mp_record,
                      "last_modules": smoke.last_record,
                      "repeatability": smoke.repeat_record}),
          flush=True)
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
