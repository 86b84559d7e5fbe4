"""CLI entry point of the port: train / validate / test a model on a dataset.

Port of ``molkgnn_tpu/cli/entry.py``, on one device or data parallel, for
every ``--gnn_type`` (kgnn, schnet, dimenet_pp, spherenet, chironet): the same
flags (every group and default of its ``build_parser``, so any argv the
JAX CLI takes parses), plus ``--device {cuda,cpu}`` (default ``cuda``),
the counterpart of ``JAX_PLATFORMS``. The derived iteration
budget (tot_iterations = ceil(train/batch)*max_epochs + 2, warmup += 2),
the dispatch on ``--validate``/``--test``, the artifacts (checkpoints under
``default_root_dir/checkpoints`` in the port's ``.pt`` format,
``logs/history.json``, ``test_result.log``, ``kernels/``, the graph
embeddings) and ``logs/task_info.log`` are the JAX CLI's.

On the card the kgnn encoder runs the hand-written scorer kernel
(``MolKGNNNet(use_kernel=True)``); on the CPU the same model takes the
scorer's plain version. The point families (SchNet, DimeNet++, SphereNet)
train on point-cloud batches whose spec has the family's ``--cutoff``
(``models/registry.py``); ChIRoNet trains on internal-coordinate batches
(``graphs/chiro.py``) from its own featurisation. The kernels
(``kernels/``) are written for kgnn only, as by the JAX CLI.
``--balanced_batches`` deals kgnn's batches by size under a tight spec
(``graphs/balance.py::spec_for_dataset``; the other families ignore the
flag, as the JAX CLI's do).

Data parallel (``parallel/``): ``--num_devices N > 1`` trains over N
ranks, one process a device. Without a launcher the CLI starts the N
processes itself (``parallel/launch.py``): rank r on ``cuda:r`` with NCCL,
or on the CPU with gloo under ``--device cpu``; N above the machine's
cards raises. Under a launcher (``torch.distributed.run``, or the JAX
package's ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``) each
process joins the launcher's world, a world of one included, and
``--num_devices`` must equal its size or stay 1. Rank 0 loads the dataset
first (it may write the ingest cache), then the others; rank 0 alone
prints the results and writes the artifacts, including the scorer launches
of its process in ``task_info.log``.

Model parallel (kgnn): ``--model_parallel halo`` node-shards every batch
over all ranks (a world of one is set up in the process when there is no
launcher and ``--num_devices`` is 1); ``--model_parallel hybrid`` makes a
``(data, model)`` mesh of ``--num_data_shards`` x ranks / shards, and the
rank count must divide by ``--num_data_shards`` (refused before any rank
starts, as the JAX CLI refuses it). ``parallel/halo.py``,
``parallel/hybrid.py``, ``TrainConfig.model_parallel``.

Run as ``python -m molkgnn_torch.cli.entry --dataset_name synthetic_motif``
(add ``--device cpu`` on a machine without a card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser(gnn_type: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="molkgnn_torch training entry (PyTorch/CUDA port)"
    )

    # Trainer group (the PL-flags analogue).
    t = p.add_argument_group("Trainer")
    t.add_argument("--max_epochs", type=int, default=20)
    t.add_argument("--default_root_dir", type=str, default=".")
    # Ranks (one process a device; see the module doc).
    t.add_argument("--num_devices", type=int, default=1)
    # none: single device (or data parallel over --num_devices); halo:
    # node-sharded halo-exchange model parallelism over the ranks (kgnn
    # only); hybrid: a data x model 2D mesh (num_data_shards x
    # ranks/num_data_shards).
    t.add_argument(
        "--model_parallel",
        choices=["none", "halo", "hybrid"],
        default="none",
    )
    t.add_argument("--num_data_shards", type=int, default=2)
    t.add_argument("--task_name", type=str, default="Unnamed")
    t.add_argument("--task_comment", type=str, default="")
    t.add_argument("--machine", type=str, default="tpu")

    # GNNModel group (reference model.py:436-465).
    m = p.add_argument_group("GNN_Model")
    m.add_argument("--seed", type=int, default=42)
    m.add_argument("--validate", action="store_true", default=False)
    m.add_argument("--test", action="store_true", default=False)
    m.add_argument("--record_valid_pred", action="store_true", default=False)
    m.add_argument("--train_metric", action="store_true", default=False)
    # Preemption-safe training: autosave full state after every epoch under
    # default_root_dir and resume from it on restart (SIGTERM/SIGINT finish
    # the epoch, autosave, and exit cleanly).
    m.add_argument("--autosave", action="store_true", default=False)
    m.add_argument("--warmup_iterations", type=int, default=60000)
    m.add_argument("--peak_lr", type=float, default=5e-2)
    m.add_argument("--end_lr", type=float, default=1e-9)
    m.add_argument("--weight_decay", type=float, default=0.0)
    m.add_argument("--ffn_dropout_rate", type=float, default=0.25)
    m.add_argument("--ffn_hidden_dim", type=int, default=64)
    m.add_argument("--task_dim", type=int, default=1)

    # Data group (reference data.py:231-239).
    d = p.add_argument_group("DataLoader")
    d.add_argument("--dataset_name", type=str, default="435034")
    d.add_argument("--num_workers", type=int, default=2)
    d.add_argument("--batch_size", type=int, default=17)
    d.add_argument(
        "--enable_oversampling_with_replacement",
        action="store_true",
        default=False,
    )
    d.add_argument("--dataset_path", type=str, default="../dataset/")
    # Size-dealt batch composition under a tight spec (graphs/balance.py;
    # kgnn only, trainer.TrainConfig.balanced_batches).
    d.add_argument("--balanced_batches", action="store_true", default=False)
    # Sample training ids on the device (alias table over the oversampling
    # distribution, a generator of their own): no per-step host input.
    # Requires --enable_oversampling_with_replacement
    # (trainer.TrainConfig.device_sampling).
    d.add_argument("--device_sampling", action="store_true", default=False)
    # Pool size for the synthetic / synthetic_motif smoke datasets only
    # (framework extension; real AIDs get their size from the SDFs).
    d.add_argument("--synthetic_graphs", type=int, default=256)
    # Optimizer steps per fused block: on the card, one train step captured
    # as a CUDA graph and replayed (identical math); on the CPU, eager steps
    # (trainer.TrainConfig.scan_steps).
    d.add_argument("--scan_steps", type=int, default=1)
    # The JAX package's scan nesting (trainer.TrainConfig.scan_chunk):
    # accepted, changes nothing on a CUDA graph.
    d.add_argument("--scan_chunk", type=int, default=0)

    p.add_argument("--gnn_type", type=str, default=gnn_type)
    # The port's counterpart of JAX_PLATFORMS: the card (default) or the
    # CPU. With cuda and no card the CLI raises; it never falls back.
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    # Model-specific groups.
    if gnn_type == "kgnn":
        g = p.add_argument_group("MolKGNNNet")
        g.add_argument("--num_layers", type=int, default=4)
        for i, dflt in ((1, 10), (2, 20), (3, 30), (4, 50)):
            g.add_argument(f"--num_kernel{i}_1hop", type=int, default=dflt)
            g.add_argument(f"--num_kernel{i}_Nhop", type=int, default=dflt)
        g.add_argument("--node_feature_dim", type=int, default=28)
        g.add_argument("--edge_feature_dim", type=int, default=7)
        g.add_argument("--hidden_dim", type=int, default=32)
        g.add_argument("--dropout_ratio", type=float, default=0.0)
        # Framework extension (default off = reference parity): apply the
        # deg-4 chirality sign at every layer, not only the last — deep
        # stacks lose pure-chirality signal otherwise (QUALITY.md 2b,
        # models/kgnn.py::MolGCN.chirality_every_layer).
        g.add_argument(
            "--chirality_every_layer", action="store_true", default=False
        )
    elif gnn_type == "schnet":
        g = p.add_argument_group("SchNet")
        g.add_argument("--num_layers", type=int, default=6)
        g.add_argument("--hidden_channels", type=int, default=128)
        g.add_argument("--num_filters", type=int, default=128)
        g.add_argument("--num_gaussians", type=int, default=50)
        g.add_argument("--cutoff", type=float, default=10.0)
        g.add_argument("--out_channels", type=int, default=32)
    elif gnn_type == "dimenet_pp":
        g = p.add_argument_group("DimeNetPP")
        g.add_argument("--hidden_channels", type=int, default=128)
        g.add_argument("--out_channels", type=int, default=32)
        g.add_argument("--num_blocks", type=int, default=4)
        g.add_argument("--int_emb_size", type=int, default=64)
        g.add_argument("--basis_emb_size", type=int, default=8)
        g.add_argument("--out_emb_channels", type=int, default=256)
        g.add_argument("--num_spherical", type=int, default=7)
        g.add_argument("--num_radial", type=int, default=6)
        g.add_argument("--cutoff", type=float, default=5.0)
        g.add_argument("--envelope_exponent", type=int, default=5)
        g.add_argument("--num_before_skip", type=int, default=1)
        g.add_argument("--num_after_skip", type=int, default=2)
        g.add_argument("--num_output_layers", type=int, default=3)
    elif gnn_type == "spherenet":
        g = p.add_argument_group("SphereNet")
        g.add_argument("--cutoff", type=float, default=5.0)
        g.add_argument("--num_layers", type=int, default=4)
        g.add_argument("--hidden_channels", type=int, default=128)
        g.add_argument("--out_channels", type=int, default=32)
        g.add_argument("--int_emb_size", type=int, default=64)
        g.add_argument("--basis_emb_size_dist", type=int, default=8)
        g.add_argument("--basis_emb_size_angle", type=int, default=8)
        g.add_argument("--basis_emb_size_torsion", type=int, default=8)
        g.add_argument("--out_emb_channels", type=int, default=256)
        g.add_argument("--num_spherical", type=int, default=7)
        g.add_argument("--num_radial", type=int, default=6)
        g.add_argument("--envelope_exponent", type=int, default=5)
        g.add_argument("--num_before_skip", type=int, default=1)
        g.add_argument("--num_after_skip", type=int, default=2)
        g.add_argument("--num_output_layers", type=int, default=3)
    elif gnn_type == "chironet":
        g = p.add_argument_group("ChIRoNet")
        g.add_argument("--F_H", type=int, default=64)
        g.add_argument("--F_H_EConv", type=int, default=64)
        g.add_argument("--GAT_N_heads", type=int, default=4)
        g.add_argument("--use_chiral_message_passing", action="store_true")
        g.add_argument("--CMP_GAT_N_layers", type=int, default=3)
        g.add_argument("--CMP_GAT_N_heads", type=int, default=2)
        g.add_argument(
            "--c_coefficient_normalization", type=str, default="sigmoid"
        )
        g.add_argument("--encoder_reduction", type=str, default="sum")
        g.add_argument("--dropout", type=float, default=0.0)
    return p


def build_model(args):
    """GNNModel of ``args.gnn_type`` from the flags, with weights drawn from
    ``--seed``; kgnn's scorer kernel on the card, its plain version on the
    CPU."""
    import torch

    from molkgnn_torch.models.registry import get_family
    from molkgnn_torch.training.model import GNNModel

    gen = torch.Generator().manual_seed(args.seed)
    make = get_family(args.gnn_type).make_encoder
    if args.gnn_type == "kgnn":
        encoder = make(
            num_layers=args.num_layers,
            kernels_1hop=(
                args.num_kernel1_1hop, args.num_kernel2_1hop,
                args.num_kernel3_1hop, args.num_kernel4_1hop,
            ),
            kernels_nhop=(
                args.num_kernel1_Nhop, args.num_kernel2_Nhop,
                args.num_kernel3_Nhop, args.num_kernel4_Nhop,
            ),
            node_dim=args.node_feature_dim,
            edge_dim=args.edge_feature_dim,
            graph_embedding_dim=args.hidden_dim,
            drop_ratio=args.dropout_ratio,
            use_kernel=args.device == "cuda",
            chirality_every_layer=args.chirality_every_layer,
            generator=gen,
        )
    elif args.gnn_type == "schnet":
        encoder = make(
            cutoff=args.cutoff, num_layers=args.num_layers,
            hidden_channels=args.hidden_channels,
            num_filters=args.num_filters, num_gaussians=args.num_gaussians,
            out_channels=args.out_channels, generator=gen,
        )
    elif args.gnn_type == "dimenet_pp":
        encoder = make(
            hidden_channels=args.hidden_channels,
            out_channels=args.out_channels, num_blocks=args.num_blocks,
            int_emb_size=args.int_emb_size,
            basis_emb_size=args.basis_emb_size,
            out_emb_channels=args.out_emb_channels,
            num_spherical=args.num_spherical, num_radial=args.num_radial,
            cutoff=args.cutoff, envelope_exponent=args.envelope_exponent,
            num_before_skip=args.num_before_skip,
            num_after_skip=args.num_after_skip,
            num_output_layers=args.num_output_layers, generator=gen,
        )
    elif args.gnn_type == "chironet":
        encoder = make(
            f_h=args.F_H, f_h_econv=args.F_H_EConv,
            gat_heads=args.GAT_N_heads,
            chiral_message_passing=args.use_chiral_message_passing,
            cmp_gat_layers=args.CMP_GAT_N_layers,
            cmp_gat_heads=args.CMP_GAT_N_heads,
            c_normalization=args.c_coefficient_normalization,
            reduction=args.encoder_reduction,
            dropout=args.dropout, generator=gen,
        )
    else:  # spherenet
        encoder = make(
            cutoff=args.cutoff, num_layers=args.num_layers,
            hidden_channels=args.hidden_channels,
            out_channels=args.out_channels, int_emb_size=args.int_emb_size,
            basis_emb_size_dist=args.basis_emb_size_dist,
            basis_emb_size_angle=args.basis_emb_size_angle,
            basis_emb_size_torsion=args.basis_emb_size_torsion,
            out_emb_channels=args.out_emb_channels,
            num_spherical=args.num_spherical, num_radial=args.num_radial,
            envelope_exponent=args.envelope_exponent,
            num_before_skip=args.num_before_skip,
            num_after_skip=args.num_after_skip,
            num_output_layers=args.num_output_layers, generator=gen,
        )
    return GNNModel(
        encoder,
        task_dim=args.task_dim,
        ffn_dropout_rate=args.ffn_dropout_rate,
        generator=gen,
    )


def build_spec(args, graphs):
    """The batch spec of ``args.gnn_type`` over ``graphs`` at
    ``--batch_size``; the point families' with their ``--cutoff``."""
    from molkgnn_torch.models.registry import get_family

    kw = {"cutoff": args.cutoff} if hasattr(args, "cutoff") else {}
    return get_family(args.gnn_type).make_spec(
        graphs, batch_size=args.batch_size, **kw)


def load_dataset(args):
    from molkgnn_torch.data.dataset import (
        D4DCHP_DATASET_NAMES,
        QSAR_DATASET_NAMES,
        make_motif_dataset,
        make_synthetic_dataset,
    )

    name = args.dataset_name
    if args.gnn_type == "chironet" and name.startswith("synthetic"):
        raise SystemExit(
            "--gnn_type chironet needs molecules with bonds and 3D "
            "positions (a QSAR or D4DCHP dataset); the synthetic datasets "
            "have neither")
    if name == "synthetic":
        return make_synthetic_dataset(
            seed=args.seed, num_graphs=args.synthetic_graphs
        )
    if name == "synthetic_motif":
        return make_motif_dataset(
            seed=args.seed, num_graphs=args.synthetic_graphs
        )
    if name in QSAR_DATASET_NAMES:
        from molkgnn_torch.data.qsar import load_qsar_dataset

        return load_qsar_dataset(
            os.path.join(args.dataset_path, "qsar", "clean_sdf"),
            dataset=name,
            gnn_type=args.gnn_type,
        )
    if name in D4DCHP_DATASET_NAMES:
        from molkgnn_torch.data.d4dchp import load_d4dchp_dataset

        base = os.path.join(args.dataset_path, "d4_docking")
        files = {
            "CHIRAL1": ("d4_docking_rs.csv", "rs/split0.npy"),
            "D4DCHP": ("d4_docking.csv", "full/split0.npy"),
            "dummy": ("dummy/dummy.csv", "dummy/split.npy"),
            "DIFF5": ("d4_docking_diff5.csv", "diff5/split0.npy"),
        }[name]
        return load_d4dchp_dataset(
            os.path.join(base, files[0]),
            name,
            os.path.join(base, files[1]),
            gnn_type=args.gnn_type,
        )
    raise ValueError(f"unknown dataset {name}")


def main(argv=None):
    t_start = time.time()
    argv = argv if argv is not None else sys.argv[1:]
    # Peek at --gnn_type to pick the per-family flag group (both
    # '--gnn_type X' and '--gnn_type=X').
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--gnn_type", default="kgnn")
    gnn_type = pre.parse_known_args(argv)[0].gnn_type
    args = build_parser(gnn_type).parse_args(argv)
    if args.device_sampling and not args.enable_oversampling_with_replacement:
        raise SystemExit(
            "--device_sampling reproduces the oversampling sampler on"
            " device; pass --enable_oversampling_with_replacement with it"
            " (shuffle-without-replacement epochs stay on the host path)"
        )

    from molkgnn_torch.parallel.multihost import env_world

    world = env_world()
    ranks = args.num_devices if world is None else world
    if args.model_parallel == "hybrid" and ranks % args.num_data_shards:
        raise SystemExit(
            f"--num_devices {ranks} not divisible by"
            f" --num_data_shards {args.num_data_shards}")
    if world is None and args.num_devices > 1:
        from molkgnn_torch.parallel.launch import spawn

        try:
            spawn(main, args.num_devices, args=(argv,), device=args.device)
        except ValueError as e:  # too few cards; raised before any rank
            raise SystemExit(f"--num_devices {args.num_devices}: {e}")
        return 0
    if world is not None and args.num_devices not in (1, world):
        raise SystemExit(
            f"--num_devices {args.num_devices} in a launched world of "
            f"{world} processes; pass {world} or 1")

    import torch.distributed as dist

    from molkgnn_torch.parallel.multihost import initialize
    from molkgnn_torch.serving.predictor import resolve_device

    device = resolve_device(args.device)  # raises for cuda without a card
    had_group = dist.is_initialized()  # a spawned rank's, kept
    try:
        if world is not None:
            initialize(device=device)
        return _run(args, t_start, device, world)
    finally:
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, t_start, device, world):
    """Train, validate or test as ``args`` says, on one device or (``world``
    not None) on this rank of the joined world."""
    import torch.distributed as dist

    from molkgnn_torch.ops import support_score as ss
    from molkgnn_torch.parallel.data_parallel import is_writer, make_mesh
    from molkgnn_torch.parallel.hybrid import make_mesh_2d
    from molkgnn_torch.training.checkpoint import SUFFIX, load_checkpoint
    from molkgnn_torch.training.trainer import TrainConfig, Trainer

    mesh = None
    if args.model_parallel == "hybrid":
        nd = args.num_data_shards
        ranks = 1 if world is None else world
        mesh = make_mesh_2d(nd, ranks // nd, device=device)
    elif args.model_parallel == "halo" or world is not None:
        mesh = make_mesh(world, device=device)
    writer = is_writer()
    before = ss.launch_counts()
    # Rank 0 first: the ingest may write its cache, which the others read.
    if not writer:
        dist.barrier()
    dataset = load_dataset(args)
    if mesh is not None and writer:
        dist.barrier()
    # Balanced batches (kgnn only; the other families ignore the flag, as
    # in the JAX CLI) run under the tight spec of the dealt batches of
    # every split and of the train draw.
    balanced = args.balanced_batches and args.gnn_type == "kgnn"
    if balanced:
        from molkgnn_torch.graphs.balance import spec_for_dataset

        spec = spec_for_dataset(
            dataset, args.batch_size,
            oversample=args.enable_oversampling_with_replacement)
    else:
        spec = build_spec(args, dataset.graphs)
    model = build_model(args)
    log_dir = os.path.join(args.default_root_dir, "logs")
    cfg = TrainConfig(
        batch_size=args.batch_size,
        max_epochs=args.max_epochs,
        peak_lr=args.peak_lr,
        end_lr=args.end_lr,
        # the reference adds 2 after deriving tot_iterations
        warmup_iterations=args.warmup_iterations + 2,
        weight_decay=args.weight_decay,
        seed=args.seed,
        oversample=args.enable_oversampling_with_replacement,
        train_metric=args.train_metric,
        record_valid_pred=args.record_valid_pred,
        log_dir=log_dir,
        checkpoint_dir=os.path.join(args.default_root_dir, "checkpoints"),
        balanced_batches=balanced,
        device_sampling=args.device_sampling,
        scan_steps=args.scan_steps,
        scan_chunk=args.scan_chunk,
        model_parallel=(None if args.model_parallel == "none"
                        else args.model_parallel),
        autosave_path=(
            os.path.join(args.default_root_dir, "autosave")
            if args.autosave
            else None
        ),
    )
    trainer = Trainer(model, dataset, spec, cfg, device=device, mesh=mesh)
    show = print if writer else (lambda *a, **k: None)

    if args.validate:
        results = trainer.evaluate("valid")
        show(json.dumps({"valid": results}, default=float))
    elif args.test:
        # Test only: restore the checkpoints of an earlier fit under the
        # same --default_root_dir, then evaluate them.
        for tag in ["last"] + [f"best_{m}" for m in cfg.monitors]:
            path = os.path.join(cfg.checkpoint_dir, tag)
            if os.path.exists(path + SUFFIX):
                trainer._ckpts[tag] = load_checkpoint(path)
        if not trainer._ckpts:
            raise SystemExit(
                f"--test: no checkpoints found under {cfg.checkpoint_dir!r};"
                " run a fit first (same --default_root_dir) or drop --test"
                " to train+test in one run"
            )
        results = trainer.test()
        show(json.dumps(results, default=float))
    else:
        trainer.fit()
        results = trainer.test()
        show(json.dumps(results, default=float))
        if args.gnn_type == "kgnn":
            trainer.save_kernels(os.path.join(log_dir, "kernels"))
        trainer.save_graph_embedding(log_dir)

    if not writer:
        return 0
    os.makedirs(log_dir, exist_ok=True)
    seconds = time.time() - t_start
    with open(os.path.join(log_dir, "task_info.log"), "a") as f:
        f.write(f"task_name: {args.task_name}\n")
        f.write(f"gnn_type: {args.gnn_type}\n")
        f.write(f"dataset: {args.dataset_name}\n")
        f.write(f"comment: {args.task_comment}\n")
        f.write(f"ranks: {1 if world is None else world}\n")
        f.write("scorer_launches: " + ", ".join(
            f"{w.__name__} {w.launches - n}"
            for w, n in zip(ss.SCORERS, before)) + "\n")
        f.write(
            f"run_time: {seconds / 3600:.0f}h{(seconds % 3600) / 60:.0f}m"
            f"{seconds % 60:.0f}s ({seconds:.1f}s)\n"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
