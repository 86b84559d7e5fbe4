"""Training harness: train step, epoch loop, checkpoints, data parallel.

Port of ``molkgnn_tpu/training/trainer.py`` (its single-device and
data-parallel paths):

  * one optimizer step per batch: train-mode forward (BatchNorm
    statistics update, dropout from the Trainer's generator), loss,
    backward, AdamW with the no-decay partition at the schedule's learning
    rate (``optim.py``, ``schedule.py``), with no host readback: the
    learning rate, the update count and the non-finite skip live on the
    device;
  * the batches come from the device-resident dataset (``use_device_data``,
    the default): the host draws the epoch's oversampled graph ids and the
    batch is assembled on the device (``graphs/device_pack.py`` for kgnn's
    ``BatchSpec``, ``graphs/device_points.py`` for the point families'
    ``PointBatchSpec``, ``graphs/device_chiro.py`` for ChIRoNet's
    ``ChiroBatchSpec``: ``serving/predictor.py::device_pipeline``); with
    ``device_sampling`` the ids are drawn on the device too, from an alias
    table and a generator of their own, ``ceil(n_train / B)`` full batches
    an epoch; or from the host loader (``GraphLoader``, with the family's
    collate, packed by a producer thread one batch ahead of the step:
    ``data/prefetch.py``) when ``use_device_data=False``;
  * ``balanced_batches`` (kgnn on the device-data path): each epoch's
    sampled ids are dealt by size into batches (``graphs/balance.py``),
    so that a tight spec (``balance.spec_for_dataset``) fits every batch;
    the sampled multiset is the same draw, only the batches' composition
    changes. Every dealt epoch and every dealt evaluation is checked on the
    host against the spec before its ids go to the device (the device's
    assembler truncates on overflow and cannot raise); evaluation
    predictions return to the caller's order;
  * ``scan_steps = K > 1`` on the card: the first use captures one whole
    train step (batch assembly from a static id buffer or the device
    sampler, forward with the scorer kernel, loss, backward, gradient fill
    and clip, skip, AdamW) as a CUDA graph, after ``GRAPH_WARMUP`` eager
    steps on a side stream, which are real steps of the run. Each block of
    K steps is then one copy of its ``[K, B]`` ids to the device and K
    replays; the last ``steps % K`` batches are replayed one by one. The
    steps, their order, dropout masks and updates are those of eager steps
    (a replay consumes the generators' Philox offsets as the eager step
    does). A failed capture raises. On the CPU, K eager steps;
  * one readback of the epoch's losses, then validation (and optionally the
    train split in eval mode, reported with a ``_no_dropout`` suffix). On
    the device-data path an evaluation scores the split's id blocks through
    ``serving/blocks.py::BlockScorer``: on the card one eval forward
    captured as a CUDA graph and replayed per block, one readback (the
    counterpart of the JAX package's scanned evaluation); the host-loader
    path evaluates eagerly, batch by batch;
  * best checkpoints per monitored metric plus ``last``, kept in memory and
    optionally written to ``checkpoint_dir``; ``test`` evaluates each and
    writes ``test_result.log`` and ``test_sample_scores_{tag}.log``;
  * full-state ``save_state``/``load_state``, and with ``autosave_path``
    an autosave after every epoch, resume, and a SIGTERM/SIGINT handler
    that finishes the epoch, autosaves and returns;
  * data parallel with ``mesh`` (``parallel/data_parallel.py::make_mesh``,
    one process a device, every rank building the same Trainer): rank 0's
    weights and statistics are broadcast once, then every rank runs the
    whole train step on its own sub-batch and, between the gradients'
    fill and the finite check, one all-reduce averages the gradients, the
    BatchNorm statistics after the step's own update and the loss
    (``GradSync``; inside the captured step on the card, so NCCL; gloo's
    host-side collectives cannot be captured and raise with
    ``scan_steps > 1`` on the card). The global batch is world x B. Every
    rank draws the same epoch order and takes its rank's batch of each
    group of ``world`` consecutive batches, the trailing partial group
    dropped, on the device-data path (balanced batches are dealt first)
    and the host loader's alike; ``fit`` raises when an epoch has fewer
    batches than ranks. With ``device_sampling`` each rank draws from a
    generator seeded from ``(seed, SAMPLE_SALT, rank)``,
    ``max(ceil(n_train / B) // world, 1)`` steps an epoch. Evaluation on
    the device-data path splits the id blocks across the ranks
    (``serving/blocks.py``) and every rank gets every prediction; the
    host-loader path evaluates the whole split on each rank. Rank 0 alone
    writes files (logs, checkpoints, autosaves, test results, kernels,
    embeddings); every rank loads. The SIGTERM stop flag is all-reduced
    once an epoch, so every rank stops after the same epoch;
  * model parallelism with ``model_parallel`` (kgnn only): ``"halo"`` over
    a one-dimensional mesh (every rank a node shard of each batch,
    ``parallel/halo.py``), ``"hybrid"`` over a ``make_mesh_2d`` mesh
    (``nd`` data groups of ``nm`` shards, ``parallel/hybrid.py``). Host-fed
    (the default): every rank draws the same whole batches from the host
    loader (not cut by rank), a step takes ``nd`` of them (one a data
    group; the trailing partial group dropped), partitioned on the host
    with the run's pinned capacities (from the first batch, widened by
    half and rounded to 8; an overflowing batch widens them from its own,
    so they only grow) and run eagerly. With ``device_sampling`` every
    halo rank draws the single-device id stream (a hybrid data group its
    own, seeded from its data index) and assembles its ``B / nm``
    molecules on the device, ``ceil(n_train / B)`` steps an epoch
    (``// nd`` under hybrid, at least 1); on an NCCL mesh with
    ``scan_steps > 1`` that step is captured, its exchanges inside the
    graph. Gradients are summed over every rank and divided by ``nm``
    (``GradSync``; the BatchNorm statistics are global in the forward and
    not reduced again). Evaluation, test and the embedding pass run the
    sharded eval forward on every rank, each split's partitions cached
    (three splits at most, rebuilt when the capacities grow). Refused:
    balanced batches, the point and ChIRoNet families, and models with
    fixed kernel sets or ``chirality_every_layer`` (``halo.check_model``).

The step counter ``step`` counts every train step. ``updates`` counts the
updates applied: Adam's count and the schedule's position. With
``skip_nonfinite_updates`` a step whose gradients are not all finite
applies no update, as the JAX package's step reverts its whole optimizer
state (optax's step counts included): only ``step`` advances. BatchNorm
statistics are taken from that step all the same, as there.

The Trainer runs on the card unless ``device="cpu"`` is passed, and raises
without CUDA. A mesh is of the Trainer's device type.

Loading state (``load_state``, checkpoints) copies into the existing
parameters, buffers, optimizer tensors and generators in place, so a
captured step stays valid and replays from the loaded state.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from molkgnn_torch.data.dataset import (
    Dataset,
    GraphLoader,
    epoch_order,
    oversampling_weights,
)
from molkgnn_torch.data.prefetch import prefetch_to_device
from molkgnn_torch.graphs.balance import (
    SIZE_FIELD,
    check_batches_fit,
    count_matrix,
    deal_by_size,
)
from molkgnn_torch.graphs.batch import spec_for_graphs
from molkgnn_torch.graphs.device_pack import (
    alias_sampler,
    pad_ids,
    sample_ids,
)
from molkgnn_torch.models.common import Dropout
from molkgnn_torch.ops.support_score import (
    add_launches,
    launch_counts,
    take_launches,
)
from molkgnn_torch.parallel.data_parallel import (
    GradSync,
    batch_norm_buffers,
    is_writer,
    mesh_rank,
    rank_rows,
    sampler_seed,
    world_group,
)
from molkgnn_torch.parallel.halo import (
    HaloBatch,
    check_model,
    halo_groups,
    halo_loss,
    model_forward,
    partition_halo,
    sampled_halo_batch,
)
from molkgnn_torch.parallel.hybrid import (
    gather_groups,
    hybrid_groups,
    partition_hybrid,
    union_caps,
)
from molkgnn_torch.serving.blocks import BlockScorer
from molkgnn_torch.serving.predictor import (
    device_pipeline,
    host_pipeline_for_spec,
    resolve_device,
    spec_family,
)
from molkgnn_torch.training.checkpoint import (
    SUFFIX,
    load_checkpoint,
    save_checkpoint,
)
from molkgnn_torch.training.metrics import compute_metrics
from molkgnn_torch.training.model import LOSSES
from molkgnn_torch.training.optim import (
    clip_by_global_norm,
    fill_missing_grads,
    grads_finite,
    make_optimizer,
)
from molkgnn_torch.training.schedule import (
    polynomial_warmup_decay,
    polynomial_warmup_decay_tensor,
)

STATE = ".state"  # save_state(path) writes path + STATE + SUFFIX
# Eager steps (real steps of the run, on a side stream) before a train step
# is captured as a CUDA graph.
GRAPH_WARMUP = 2
# Salt of the device sampler's seed, so that its stream never meets the
# dropout stream's (the JAX package folds the same salt into its key).
SAMPLE_SALT = 0x5A17
# Model parallelism's pinned capacities: the needed ones times this,
# rounded up to 8 (the JAX Trainer's margin).
CAPS_MARGIN = 1.5
# Evaluation splits whose partitions are kept (valid, test, train).
EVAL_CACHE_MAX = 3


@dataclasses.dataclass
class TrainConfig:
    batch_size: int = 16
    max_epochs: int = 20
    peak_lr: float = 5e-3
    end_lr: float = 1e-10
    warmup_iterations: int = 300
    weight_decay: float = 1e-3
    seed: int = 42
    oversample: bool = True
    train_metric: bool = False
    monitors: tuple = ("logAUC_0.001_0.1", "AUC", "loss")
    log_dir: str = "logs"
    checkpoint_dir: Optional[str] = None
    tot_iterations: Optional[int] = None
    progress: bool = True
    # Write each epoch's validation predictions to
    # log_dir/valid_predictions/epoch_N.
    record_valid_pred: bool = False
    grad_clip_norm: Optional[float] = None
    skip_nonfinite_updates: bool = False
    # Keep the flat-packed dataset on the device and assemble batches there
    # from the sampled ids; False packs each batch on the host.
    use_device_data: bool = True
    # Optimizer steps per fused block. On the card a train step is captured
    # once as a CUDA graph and each block of K steps is K replays (see the
    # module doc); on the CPU, K eager steps. The math is that of K eager
    # steps.
    scan_steps: int = 1
    # The JAX package nests its K-step lax.scan as (K // chunk x chunk)
    # when chunk divides K, to bound the compiled program for a remote
    # compiler's capacity limit. A captured CUDA graph has no such limit:
    # accepted (any int, as there) and changes nothing here.
    scan_chunk: int = 0
    # Draw the train ids on the device from the oversampling distribution
    # (alias table, a generator of its own): no per-step host input.
    # Requires use_device_data and oversample.
    device_sampling: bool = False
    # Deal each epoch's sampled ids (and each evaluation's) into batches by
    # size (graphs/balance.py), so that every batch fits a tight spec
    # (balance.spec_for_dataset); each dealt matrix is checked against the
    # spec on the host. Requires the device-data path and kgnn batches;
    # excludes device_sampling (dealing is host-side).
    balanced_batches: bool = False
    autosave_path: Optional[str] = None
    # Model parallelism for kgnn over the Trainer's mesh: "halo" (node
    # shards of each batch), "hybrid" (a 2D data x model mesh); None is data
    # parallelism over the mesh (see the module doc).
    model_parallel: Optional[str] = None

    def resolve_tot_iterations(self, num_train: int) -> int:
        if self.tot_iterations is not None:
            return self.tot_iterations
        # ceil(train / batch) * max_epochs + 2, as the reference derives it
        per_epoch = -(-num_train // self.batch_size)
        return per_epoch * self.max_epochs + 2


def _widen(caps: dict) -> dict:
    """Pinned capacities from needed ones (``CAPS_MARGIN``, multiples of
    8); the node rows a shard stay the spec's."""
    def w(v):
        return -(-int(v * CAPS_MARGIN) // 8) * 8

    return {"ns": caps["ns"], "hp": w(caps["hp"]), "el": w(caps["el"]),
            "eh": w(caps["eh"]),
            "buckets": tuple(w(b) for b in caps["buckets"])}


class Trainer:
    def __init__(
        self,
        model: nn.Module,
        dataset: Dataset,
        spec,
        config: TrainConfig,
        device: Optional[str | torch.device] = None,
        monitor=None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"a {mesh.device_type} mesh for a Trainer on "
                f"{self.device.type}")
        if self.device.type == "cuda":
            # Full fp32 products: the permutation argmax would move with
            # TF32's lost digits.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device)
        self.dataset = dataset
        self.spec = spec
        self.config = config
        self.monitor = monitor
        self.mesh = mesh
        self.world, self.rank = (1, 0) if mesh is None else mesh_rank(mesh)
        # Model parallelism: this rank's groups (halo.HaloGroups).
        self._mp = self._model_parallel(config.model_parallel, mesh, spec)
        self.loss_fn = LOSSES[dataset.loss_name]
        self.history: List[Dict[str, float]] = []
        self.best: Dict[str, float] = {}
        self.step_losses: List[float] = []
        self._ckpts: Dict[str, dict] = {}

        train_ids = np.asarray(dataset.split["train"])
        sched = dict(
            peak_lr=config.peak_lr,
            end_lr=config.end_lr,
            warmup_iterations=config.warmup_iterations,
            tot_iterations=config.resolve_tot_iterations(len(train_ids)),
        )
        self.schedule = polynomial_warmup_decay(**sched)
        self._lr = polynomial_warmup_decay_tensor(**sched)
        self.optimizer = make_optimizer(
            self.model, weight_decay=config.weight_decay
        )
        self._params = self.optimizer.params
        self.step = 0
        # The run's random streams, all from config.seed: dropout masks (on
        # the device), the sampled graph ids (on the host) and, with
        # device_sampling, the ids drawn on the device.
        self.dropout_rng = torch.Generator(device=self.device)
        self.dropout_rng.manual_seed(config.seed)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.dropout_rng
        self.id_rng = np.random.default_rng(config.seed)
        # Data parallel: a stream a rank; halo: the single-device stream on
        # every rank; hybrid: a stream a data group.
        stream = None if mesh is None else self.rank
        if config.model_parallel == "halo":
            stream = None
        elif config.model_parallel == "hybrid":
            stream = mesh.get_local_rank("data")
        self.sample_rng = torch.Generator(device=self.device)
        self.sample_rng.manual_seed(sampler_seed(
            config.seed, SAMPLE_SALT, stream))
        self._train_ids = train_ids
        self._train_labels = np.array([dataset.graphs[i].y for i in train_ids])
        # The spec's batch family: the host loader's collate (None: kgnn's
        # flat-packed loader) and the device dataset and gather.
        self._collate = (host_pipeline_for_spec(spec)[1]
                         if spec_family(spec) != "kgnn" else None)
        build, self._gather = device_pipeline(spec)
        self._device_data = None
        # Model parallelism assembles batches on the device only when it
        # samples there; else they are partitioned on the host.
        if config.use_device_data and (self._mp is None
                                       or config.device_sampling):
            self._device_data = build(dataset.graphs, self.device)
        self._shard_spec = None
        if self._mp is not None and config.device_sampling:
            nm = self._mp.n_model
            if config.batch_size % nm:
                raise ValueError(
                    f"device_sampling with model_parallel="
                    f"{config.model_parallel!r} needs batch_size divisible"
                    f" by the {nm} model shards (got {config.batch_size})")
            self._shard_spec = spec_for_graphs(dataset.graphs,
                                               config.batch_size // nm)
        # Model parallelism's pinned capacities and cached evaluation
        # partitions.
        self._caps = None
        self._eval_parts: Dict[tuple, tuple] = {}
        # Per-graph padded-field sizes, what balanced mode deals and checks.
        self._counts = None
        if config.balanced_batches:
            if self._mp is not None:
                raise ValueError(
                    "balanced_batches deals the device-data path's batches; "
                    "model_parallel partitions host-loader batches or "
                    "samples on the device")
            if self._device_data is None or self._collate is not None:
                raise ValueError(
                    "balanced_batches requires the device-data path "
                    "(use_device_data=True) and kgnn batches"
                )
            self._counts = count_matrix(dataset.graphs)
        self._sampler = None
        if config.device_sampling:
            if self._device_data is None:
                raise ValueError(
                    "device_sampling requires the device-data path "
                    "(use_device_data=True)"
                )
            if not config.oversample:
                raise ValueError(
                    "device_sampling reproduces the oversampling "
                    "(with-replacement) sampler; shuffle epochs stay on the "
                    "host path"
                )
            if config.balanced_batches:
                raise ValueError(
                    "device_sampling and balanced_batches are mutually "
                    "exclusive (dealing is host-side)"
                )
            table = alias_sampler(oversampling_weights(self._train_labels))
            self._sampler = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (table.prob, table.alias,
                          train_ids.astype(np.int32))
            )
        # The captured train step (scan_steps > 1 on the card): the graph,
        # its static id input and loss output, the scorer launches one
        # replay makes, and the eager steps run so far towards its warm-up.
        self._graph = None
        self._graph_ids = None
        self._graph_loss = None
        self._graph_launches = None
        self._graph_warm = 0
        # Evaluation over id blocks of the device-resident dataset.
        self._blocks = BlockScorer(self.model, spec)
        # The data-parallel step's collective; rank 0's weights and
        # statistics replicated.
        self._sync = None
        if mesh is not None:
            if (config.scan_steps > 1 and self.device.type == "cuda"
                    and dist.get_backend(world_group(mesh)) != "nccl"):
                raise ValueError(
                    "scan_steps > 1 on the card needs an NCCL mesh: a "
                    "gloo collective runs on the host and cannot be "
                    "captured in a CUDA graph")
            buffers = batch_norm_buffers(self.model)
            if self._mp is None:
                self._sync = GradSync(mesh, self._params, buffers)
            else:  # statistics global already; see GradSync
                self._sync = GradSync(mesh, self._params, [],
                                      divisor=self._mp.n_model)
            self._sync.broadcast(self._params + buffers)

    @property
    def updates(self) -> int:
        """Updates applied (reads the device's count back)."""
        return int(self.optimizer.count)

    def _model_parallel(self, kind, mesh, spec):
        """The groups of ``config.model_parallel`` on ``mesh``, or None;
        refuses what it cannot run (the JAX Trainer's checks, and the
        model options the sharded forward does not keep)."""
        if kind is None:
            return None
        if kind not in ("halo", "hybrid"):
            raise ValueError(f"unknown model_parallel={kind!r}"
                             " (supported: 'halo', 'hybrid')")
        if mesh is None:
            raise ValueError(f"model_parallel={kind!r} requires a mesh")
        if spec_family(spec) != "kgnn":
            raise ValueError("model_parallel supports the kgnn batch family"
                             " only")
        check_model(self.model.gnn_model)
        sampled = self.config.device_sampling
        if kind == "halo":
            return halo_groups(mesh, sampled)
        return hybrid_groups(mesh, sampled)

    # ------------------------------------------------------------------
    def _loss(self, batch) -> torch.Tensor:
        """Train-mode forward and loss, gradients zeroed in place (under
        model parallelism ``batch`` is this rank's ``HaloBatch`` shard)."""
        self.model.train()
        self.optimizer.zero_grad()
        if self._mp is not None:
            return halo_loss(self.model, self.loss_fn, batch, self._mp)
        pred, _ = self.model(batch)
        return self.loss_fn(pred, batch.y, batch.graph_mask)

    def _update(self) -> None:
        """Apply one update from the gradients in place (see module doc),
        with no host readback."""
        fill_missing_grads(self._params)
        ok = (grads_finite(self._params)
              if self.config.skip_nonfinite_updates else None)
        if self.config.grad_clip_norm is not None:
            clip_by_global_norm(self._params, self.config.grad_clip_norm)
        self.optimizer.step(self._lr(self.optimizer.count), ok)

    def _step(self, batch) -> torch.Tensor:
        """One train step; returns the loss (under a mesh the mean over the
        ranks, the gradients and statistics averaged first), left on the
        device."""
        loss = self._loss(batch)
        loss.backward()
        loss = loss.detach()
        if self._sync is not None:
            fill_missing_grads(self._params)
            loss = self._sync(loss)
        self._update()
        self.step += 1
        return loss

    def _step_ids(self, ids: np.ndarray) -> torch.Tensor:
        """One train step on the batch of graph ids [B] (-1 padded),
        assembled on the device."""
        ids_dev = torch.as_tensor(ids, device=self.device)
        return self._step(self._gather(self._device_data, ids_dev, self.spec))

    def _device_step(self) -> torch.Tensor:
        """One train step with no host input and no host readback: ids
        drawn on the device (device_sampling) or read from the static id
        buffer. This is the step a CUDA graph captures."""
        if self._sampler is not None:
            prob, alias, train_ids = self._sampler
            ids = sample_ids(self.sample_rng, prob, alias, train_ids,
                             self.config.batch_size)
        else:
            ids = self._graph_ids
        if self._mp is not None:
            return self._step(sampled_halo_batch(
                self._device_data, ids, self._shard_spec, self._gather,
                self._mp.n_model, self._mp.index))
        return self._step(self._gather(self._device_data, ids, self.spec))

    def _capture(self) -> None:
        """Capture ``_device_step`` as a CUDA graph, with the Trainer's
        generators registered so that every replay draws fresh masks and
        ids. Raises if the capture fails; nothing falls back to eager."""
        graph = torch.cuda.CUDAGraph()
        if not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                "scan_steps > 1 on CUDA needs "
                "torch.cuda.CUDAGraph.register_generator_state (torch >= 2.4)"
            )
        for gen in (self.dropout_rng, self.sample_rng):
            graph.register_generator_state(gen)
        step = self.step
        before = launch_counts()
        # Under a mesh the step records an NCCL collective: the warm-up's
        # works are let finish first, and the capture checks this thread's
        # calls only (the process group's watchdog thread polls events).
        mode = "global"
        if self.mesh is not None:
            torch.cuda.synchronize(self.device)
            mode = "thread_local"
        with torch.cuda.graph(graph, capture_error_mode=mode):
            self._graph_loss = self._device_step()
        # The capture runs nothing: the steps and the scorer launches it
        # recorded are counted at each replay instead.
        self.step = step
        self._graph_launches = take_launches(before)
        self._graph = graph

    def _graph_step(self, ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One train step through the captured graph (captured on first
        use, after GRAPH_WARMUP eager steps on a side stream). ``ids``: [B]
        int32 on the device, or None with device_sampling."""
        if self._graph_ids is None:
            self._graph_ids = torch.full(
                (self.config.batch_size,), -1, dtype=torch.int32,
                device=self.device,
            )
        if ids is not None:
            self._graph_ids.copy_(ids)
        if self._graph is None and self._graph_warm < GRAPH_WARMUP:
            side = torch.cuda.Stream(device=self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                loss = self._device_step()
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._graph_warm += 1
            return loss
        if self._graph is None:
            self._capture()
        self._graph.replay()
        self.step += 1
        add_launches(self._graph_launches)
        return self._graph_loss.clone()

    def _epoch_steps(self) -> List[torch.Tensor]:
        """One epoch's train steps on the device-resident data; returns
        their losses, left on the device."""
        cfg = self.config
        k = max(cfg.scan_steps, 1)
        graphed = k > 1 and self.device.type == "cuda"
        if self._sampler is not None:
            steps = -(-len(self._train_ids) // cfg.batch_size)
            if self.mesh is not None:  # a step takes a batch a data group
                steps = max(steps // self._data_groups(), 1)
            if graphed:
                return [self._graph_step() for _ in range(steps)]
            return [self._device_step() for _ in range(steps)]
        blocks = rank_rows(np.stack(list(self._epoch_id_batches())),
                           self.world, self.rank)
        if not graphed:
            return [self._step_ids(ids) for ids in blocks]
        losses = []
        whole = (len(blocks) // k) * k
        for start in range(0, whole, k):
            block = torch.as_tensor(blocks[start:start + k],
                                    device=self.device)
            losses += [self._graph_step(ids) for ids in block]
        for ids in blocks[whole:]:
            losses.append(
                self._graph_step(torch.as_tensor(ids, device=self.device))
            )
        return losses

    def _data_groups(self) -> int:
        """Batches a step takes: the ranks, or the hybrid data groups."""
        return self.world // (1 if self._mp is None else self._mp.n_model)

    def _mp_epoch(self, loader) -> List[torch.Tensor]:
        """One host-fed model-parallel epoch: every rank draws the same
        batches; a step takes one a data group, partitioned with the pinned
        capacities (the trailing partial group dropped)."""
        nd = self._data_groups()
        losses, group = [], []
        for batch in loader:
            group.append(batch)
            if len(group) == nd:
                losses.append(self._step(self._mine(self._partition(group))))
                group = []
        return losses

    def _partition(self, batches) -> HaloBatch:
        """``batches`` (one a data group) partitioned over the model shards
        with the run's pinned capacities, grown from an overflowing batch
        (see the module doc); numpy, every shard."""
        nm = self._mp.n_model

        def needed(batch):
            return _widen(partition_halo(batch, nm).caps())

        if self._caps is None:
            self._caps = needed(batches[0])
            for b in batches[1:]:
                self._caps = union_caps(self._caps, needed(b))
        try:
            return partition_hybrid(batches, nm, caps=self._caps)
        except ValueError:
            for b in batches:
                self._caps = union_caps(self._caps, needed(b))
            return partition_hybrid(batches, nm, caps=self._caps)

    def _mine(self, hb: HaloBatch) -> HaloBatch:
        """This rank's shard of a ``_partition`` batch, on the device in
        the model's dtype."""
        index = (self.rank // self._mp.n_model, self._mp.index)
        return hb.shard(index, self.device, self._params[0].dtype)

    def _epoch_id_batches(self):
        """The epoch's sampled train ids, batch by batch, -1 padded: the
        loader's oversampling (or shuffle) over global graph ids; in
        balanced mode the same draw, dealt by size and checked."""
        cfg = self.config
        order = epoch_order(
            self.id_rng, self._train_labels, cfg.oversample, shuffle=True
        )
        sampled = self._train_ids[order]
        if self._counts is not None:
            yield from self._deal(sampled)[0]
            return
        for start in range(0, len(sampled), cfg.batch_size):
            yield pad_ids(sampled[start : start + cfg.batch_size],
                          cfg.batch_size)

    def _deal(self, ids: np.ndarray):
        """(id matrix, position matrix) of ``ids`` dealt by size into
        batches (``balance.deal_by_size``), checked against the spec on the
        host: raises before any overflowing batch reaches the device."""
        counts = self._counts
        idm, posm = deal_by_size(ids, counts[ids, SIZE_FIELD],
                                 self.config.batch_size)
        check_batches_fit(idm, counts, self.spec)
        return idm, posm

    def _id_blocks(self, ids: np.ndarray):
        """(id matrix [S, B], positions in ``ids`` of its entries) of the
        graphs ``ids`` for evaluation: consecutive chunks, or dealt by size
        in balanced mode (consecutive chunks of a split may overflow a
        tight spec). -1 pads both."""
        bs = self.config.batch_size
        if self._counts is not None:
            return self._deal(ids)
        pos = np.arange(len(ids))
        blocks = range(0, len(ids), bs)
        return (np.stack([pad_ids(ids[s : s + bs], bs) for s in blocks]),
                np.stack([pad_ids(pos[s : s + bs], bs) for s in blocks]))

    @staticmethod
    def _in_order(flat: np.ndarray, posm: np.ndarray, n: int) -> np.ndarray:
        """Rows of ``flat`` (one per entry of ``posm``, flattened) put back
        at their positions, padding dropped."""
        pos = posm.reshape(-1)
        valid = pos >= 0
        out = np.empty((n, *flat.shape[1:]), flat.dtype)
        out[pos[valid]] = flat[valid]
        return out

    # ------------------------------------------------------------------
    def _predict_ids(self, ids: np.ndarray):
        """(labels, predictions) of the graphs ``ids``, assembled on the
        device in batches and scored block by block (``BlockScorer``: graph
        replays on the card); one copy of the ids to the device and one
        readback of the predictions, in the order of ``ids``."""
        ids = np.asarray(ids)
        idm, posm = self._id_blocks(ids)
        self.model.eval()
        preds = self._blocks(self._device_data,
                             torch.as_tensor(idm, device=self.device),
                             mesh=self.mesh)
        flat = preds.cpu().numpy().reshape(-1)
        true = np.array([self.dataset.graphs[i].y for i in ids], np.float32)
        return true, self._in_order(flat, posm, len(ids))

    @torch.no_grad()
    def _predict(self, graphs):
        """(labels, predictions) of ``graphs``, packed on the host; one
        readback of the predictions."""
        loader = GraphLoader(graphs, self.spec, self.config.batch_size,
                             collate=self._collate)
        self.model.eval()
        preds, masks, trues = [], [], []
        for batch in loader:
            preds.append(self.model(batch.to(self.device))[0])
            masks.append(batch.graph_mask.numpy())
            trues.append(batch.y.numpy())
        all_pred = torch.cat(preds).cpu().numpy()
        mask = np.concatenate(masks)
        return np.concatenate(trues)[mask], all_pred[mask]

    @torch.no_grad()
    def _predict_mp(self, graphs):
        """(labels, predictions, embeddings) of ``graphs`` through the
        model-parallel eval forward, on every rank: the batches of the
        host loader, ``nd`` at a time (the last group padded by repeating
        its last batch), partitioned with the pinned capacities (cached by
        split: see the module doc); one readback."""
        nd = self._data_groups()
        idx = tuple(g.idx for g in graphs)
        key = None if any(i < 0 for i in idx) else idx  # no identity
        hit = self._eval_parts.get(key) if key else None
        if hit is None or hit[0] != repr(self._caps):
            batches = list(GraphLoader(graphs, self.spec,
                                       self.config.batch_size))
            groups = []
            for start in range(0, len(batches), nd):
                grp = batches[start:start + nd]
                groups.append((self._partition(
                    grp + [grp[-1]] * (nd - len(grp))), len(grp)))
            hit = (repr(self._caps), groups,
                   np.concatenate([b.graph_mask.numpy() for b in batches]),
                   np.concatenate([b.y.numpy() for b in batches]))
            if key is not None:
                if (key not in self._eval_parts
                        and len(self._eval_parts) >= EVAL_CACHE_MAX):
                    self._eval_parts.pop(next(iter(self._eval_parts)))
                self._eval_parts[key] = hit
        _, groups, mask, trues = hit
        preds, embs = [], []
        for hb, n_real in groups:
            pred, emb = model_forward(self.model, self._mine(hb), self._mp,
                                      train=False)
            if nd > 1:  # every data group's batch, in group order
                pred = gather_groups(pred, self._mp)
                emb = gather_groups(emb, self._mp)
            else:
                pred, emb = pred[None], emb[None]
            preds.append(pred[:n_real].reshape(-1))
            embs.append(emb[:n_real].reshape(-1, emb.shape[-1]))
        pred = torch.cat(preds).cpu().numpy()
        emb = torch.cat(embs).cpu().numpy()
        return trues[mask], pred[mask], emb[mask]

    def _predictions(self, part: str):
        if self._mp is not None:
            return self._predict_mp(self.dataset.subset(part))[:2]
        if self._device_data is not None:
            return self._predict_ids(self.dataset.split[part])
        return self._predict(self.dataset.subset(part))

    def evaluate(self, part: str = "valid") -> Dict[str, float]:
        true_y, pred_y = self._predictions(part)
        results = compute_metrics(self.dataset.metrics, true_y, pred_y)
        pred = torch.from_numpy(pred_y)
        results["loss"] = float(
            self.loss_fn(
                pred,
                torch.from_numpy(true_y),
                torch.ones(pred.shape, dtype=torch.bool),
            )
        )
        return results

    # ------------------------------------------------------------------
    def fit(self) -> List[Dict[str, float]]:
        """Train for max_epochs. With ``config.autosave_path`` set, resume
        from its autosave where there is one (the epochs done are not run
        again), autosave after every epoch, and turn SIGTERM/SIGINT into
        finish the epoch, autosave, return."""
        cfg = self.config
        start_epoch = 0
        if cfg.autosave_path and os.path.exists(
            cfg.autosave_path + STATE + SUFFIX
        ):
            self.load_state(cfg.autosave_path)
            hpath = cfg.autosave_path + ".history.json"
            if os.path.exists(hpath):
                with open(hpath) as f:
                    self.history = json.load(f)
            start_epoch = len(self.history)
        stop = {"flag": False}
        old_handlers = {}
        if cfg.autosave_path:
            def _request_stop(signum, frame):
                stop["flag"] = True

            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    old_handlers[sig] = signal.signal(sig, _request_stop)
                except ValueError:
                    pass  # not the main thread; signals handled elsewhere
        try:
            return self._fit_loop(start_epoch, stop)
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)

    def _fit_loop(self, start_epoch, stop) -> List[Dict[str, float]]:
        cfg = self.config
        batches = -(-len(self._train_ids) // cfg.batch_size)
        if self._mp is None and self.world > 1 and batches < self.world:
            raise ValueError(
                "data-parallel fit() needs at least one id-batch per device:"
                f" ceil(n_train/batch_size) = {batches} < {self.world}"
                " devices. Shrink the mesh or the batch size."
            )
        writer = is_writer()
        if writer:
            os.makedirs(cfg.log_dir, exist_ok=True)
        loader = None
        if self._device_data is None:
            loader = GraphLoader(
                self.dataset.subset("train"),
                self.spec,
                cfg.batch_size,
                shuffle=not cfg.oversample,
                oversample=cfg.oversample,
                seed=self.id_rng,
                collate=self._collate,
                # Model parallelism: every rank draws the whole batches.
                shard=(0, 1) if self._mp else (self.rank, self.world),
            )
        for epoch in range(start_epoch, cfg.max_epochs):
            t0 = time.time()
            if loader is None:
                losses = self._epoch_steps()
            elif self._mp is not None:
                losses = self._mp_epoch(loader)
            else:
                losses = [self._step(b.to(self.device))
                          for b in prefetch_to_device(loader)]
            if not losses:
                raise RuntimeError("fit(): the epoch had no train step")
            t_dispatch = time.time()
            # The epoch's one readback.
            step_losses = torch.stack(losses).cpu()
            train_loss = float(step_losses.mean())
            self.step_losses.extend(step_losses.tolist())
            t_readback = time.time()

            results = self.evaluate("valid")
            if cfg.record_valid_pred:
                true_y, pred_y = self._predictions("valid")
            if cfg.record_valid_pred and writer:
                pred_dir = os.path.join(cfg.log_dir, "valid_predictions")
                os.makedirs(pred_dir, exist_ok=True)
                with open(os.path.join(pred_dir, f"epoch_{epoch}"), "w") as f:
                    for pv, tv in zip(pred_y, true_y):
                        f.write(f"{pv},{tv}\n")
            if cfg.train_metric:
                for k, v in self.evaluate("train").items():
                    results[f"{k}_no_dropout"] = v
            results["train_loss"] = train_loss
            results["epoch"] = epoch
            results["epoch_time_s"] = time.time() - t0
            # Wall-time split: launching the epoch's steps, the loss
            # readback that waits for them, and evaluation.
            results["train_dispatch_time_s"] = t_dispatch - t0
            results["train_readback_time_s"] = t_readback - t_dispatch
            results["eval_time_s"] = time.time() - t_readback
            self.history.append(results)
            if self.monitor is not None and writer:
                self.monitor.on_epoch_end(epoch, results)
            self._update_checkpoints(results)
            if cfg.progress and writer:
                shown = {
                    k: round(v, 4)
                    for k, v in results.items()
                    if isinstance(v, float)
                }
                print(f"epoch {epoch}: {shown}", flush=True)
            if cfg.autosave_path:
                self.save_state(cfg.autosave_path)
                if writer:
                    with open(cfg.autosave_path + ".history.json", "w") as f:
                        json.dump(self.history, f)
                if self._sync is not None:  # every rank stops together
                    stop["flag"] = self._sync.any(stop["flag"])
            if stop["flag"]:
                if cfg.progress and writer:
                    print(
                        f"fit: stop signal received; autosaved after "
                        f"epoch {epoch}, returning early",
                        flush=True,
                    )
                break
        self._save_checkpoint("last")
        if writer:
            with open(os.path.join(cfg.log_dir, "history.json"), "w") as f:
                json.dump(self.history, f, indent=1)
        return self.history

    # ------------------------------------------------------------------
    def _update_checkpoints(self, results: Dict[str, float]):
        for monitor in self.config.monitors:
            if monitor not in results:
                continue
            value = results[monitor]
            better = (
                value < self.best.get(monitor, np.inf)
                if monitor == "loss"
                else value > self.best.get(monitor, -np.inf)
            )
            if better:
                self.best[monitor] = value
                self._save_checkpoint(f"best_{monitor}")

    def _save_checkpoint(self, tag: str):
        """Keep the weights and BatchNorm statistics under ``tag`` (on the
        device), and write them to ``checkpoint_dir/{tag}.pt`` if set (rank
        0 alone under a mesh: ``save_checkpoint``)."""
        payload = {
            "step": self.step,
            "model": {
                k: v.detach().clone()
                for k, v in self.model.state_dict().items()
            },
        }
        self._ckpts[tag] = payload
        if self.config.checkpoint_dir:
            save_checkpoint(
                os.path.join(self.config.checkpoint_dir, tag), payload
            )

    def load_checkpoint_tag(self, tag: str):
        self.model.load_state_dict(self._ckpts[tag]["model"])

    # ------------------------------------------------------------------
    def save_state(self, path: str) -> None:
        """Full state for resume, at ``path + ".state.pt"``: weights and
        statistics, optimizer (its update count included), the three random
        streams, step count, epochs done, best-metric table. Under a mesh
        every rank calls it: the device samplers' states of all ranks are
        gathered (a list by rank), and rank 0 writes."""
        sample_rng = self.sample_rng.get_state()
        if self._sync is not None:
            sample_rng = self._sync.gather_objects(sample_rng)
        save_checkpoint(path + STATE, {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "dropout_rng": self.dropout_rng.get_state(),
            "sample_rng": sample_rng,
            "id_rng": self.id_rng.bit_generator.state,
            "step": self.step,
            "epochs_done": len(self.history),
            "best": dict(self.best),
        })

    def load_state(self, path: str) -> None:
        """Restore ``save_state(path)``, in place (see the module doc); a
        state saved under a mesh restores on a mesh of the same size, each
        rank its own sampler's state."""
        ck = load_checkpoint(path + STATE)
        sample_rng = ck["sample_rng"]
        saved = len(sample_rng) if isinstance(sample_rng, list) else None
        if saved != (None if self._sync is None else self.world):
            raise ValueError(
                f"{path}: a state saved on {saved or 'no'} mesh ranks, "
                f"loaded on {self.world if self._sync else 'no'}")
        if saved is not None:
            sample_rng = sample_rng[self.rank]
        self.model.load_state_dict(ck["model"])
        self.optimizer.load_state_dict(ck["optimizer"])
        self.dropout_rng.set_state(ck["dropout_rng"])
        self.sample_rng.set_state(sample_rng)
        self.id_rng.bit_generator.state = ck["id_rng"]
        self.step = ck["step"]
        self.best = {k: float(v) for k, v in ck["best"].items()}

    def save_kernels(self, out_dir: str):
        """Write the first layer's learned kernels to ``kernels.npz``, keyed
        ``kernelconv{d}/{name}`` as the JAX package keys them; a fixed
        set's parameters (its score weights) under
        ``fixed_kernelconv{d}/{name}``. Rank 0 alone writes."""
        if not is_writer():
            return
        layers = getattr(getattr(self.model.gnn_model, "gnn", None),
                         "layers", None)
        if not layers:
            raise ValueError("save_kernels: model has no kgnn layer 0")
        os.makedirs(out_dir, exist_ok=True)
        convs = [(f"kernelconv{d}", conv) for d, conv in
                 enumerate(layers[0].trainable_kernelconv_set, 1)]
        convs += [(f"fixed_kernelconv{int(d) + 1}", conv) for d, conv in
                  layers[0].fixed_kernelconv_set.items()]
        flat = {
            f"{prefix}/{name}": p.detach().cpu().numpy()
            for prefix, conv in convs
            for name, p in conv.named_parameters()
        }
        np.savez(os.path.join(out_dir, "kernels.npz"), **flat)

    @torch.no_grad()
    def save_graph_embedding(self, out_dir: str, part: str = "test"):
        """Write the split's graph embeddings and smiles, in split order
        (balanced mode: batches dealt and checked as in evaluation, then
        put back in order). Rank 0 alone computes and writes them; under
        model parallelism every rank runs the sharded forward."""
        graphs = self.dataset.subset(part)
        if self._mp is not None:
            all_emb = self._predict_mp(graphs)[2]
        if not is_writer():
            return
        os.makedirs(out_dir, exist_ok=True)
        self.model.eval()
        if self._mp is None and self._counts is not None:
            ids = np.asarray(self.dataset.split[part])
            idm, posm = self._deal(ids)
            embs = [
                self.model(self._gather(
                    self._device_data,
                    torch.as_tensor(row, device=self.device), self.spec))[1]
                for row in idm
            ]
            all_emb = self._in_order(torch.cat(embs).cpu().numpy(), posm,
                                     len(ids))
        elif self._mp is None:
            embs, masks = [], []
            for batch in GraphLoader(graphs, self.spec,
                                     self.config.batch_size,
                                     collate=self._collate):
                embs.append(self.model(batch.to(self.device))[1])
                masks.append(batch.graph_mask.numpy())
            all_emb = torch.cat(embs).cpu().numpy()[np.concatenate(masks)]
        np.save(os.path.join(out_dir, "graph_embedding.npy"), all_emb)
        with open(
            os.path.join(out_dir, "smiles_for_graph_embedding.txt"), "w"
        ) as f:
            for g in graphs:
                f.write(getattr(g, "smiles", "") + "\n")

    def test(self) -> Dict[str, Dict[str, float]]:
        """Evaluate ``last`` and each best checkpoint on the test split;
        write ``test_sample_scores_{tag}.log`` and ``test_result.log``.
        Under a mesh every rank evaluates and rank 0 writes."""
        cfg = self.config
        out: Dict[str, Dict[str, float]] = {}
        tags = [
            t
            for t in ["last"] + [f"best_{m}" for m in cfg.monitors]
            if t in self._ckpts
        ]
        current = {
            k: v.detach().clone() for k, v in self.model.state_dict().items()
        }
        writer = is_writer()
        if writer:
            os.makedirs(cfg.log_dir, exist_ok=True)
        for tag in tags:
            self.load_checkpoint_tag(tag)
            true_y, pred_y = self._predictions("test")
            out[tag] = compute_metrics(self.dataset.metrics, true_y, pred_y)
            if not writer:
                continue
            path = os.path.join(cfg.log_dir, f"test_sample_scores_{tag}.log")
            with open(path, "w") as f:
                for p, t in zip(pred_y, true_y):
                    f.write(f"{p},{t}\n")
        self.model.load_state_dict(current)
        if not writer:
            return out
        with open(os.path.join(cfg.log_dir, "test_result.log"), "w") as f:
            for tag, metrics in out.items():
                f.write(f"[{tag}]\n")
                for k, v in metrics.items():
                    f.write(f"{k}: {v}\n")
        return out
