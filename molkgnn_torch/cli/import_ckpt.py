"""`molkgnn-torch-import`: reference torch checkpoint -> exported model.

Port of ``molkgnn_tpu/cli/import_ckpt.py`` for every ``--gnn_type``
(kgnn, SchNet, DimeNet++, SphereNet, ChIRoNet). A user of the reference
trains with PyTorch Lightning and holds a PL ``.ckpt`` or a raw
``state_dict``; this CLI loads it into the port's
model (``training/checkpoint.py::load_torch_checkpoint``, which checks
every key and shape) and writes the serving artifact of
``Predictor.export`` in one step:

    molkgnn-torch-import --torch_ckpt best.ckpt --sdf library.sdf \\
        --out model.pt2
    molkgnn-torch-screen --exported model.pt2 --sdf library.sdf \\
        --out scores.csv

The model-shape flags are the training CLI's (``cli/entry.py``) and must
match the checkpoint's training configuration. ``--sdf`` gives the library
the artifact's static batch spec must cover (the point families' with
their ``--cutoff``; ChIRoNet's over the molecules that have a dihedral,
featurized with ``mol_to_chiro_graph``). ``--device`` (default ``cuda``)
is the device the program is exported on, and so the one it serves on: on
the card kgnn's scorer is the hand-written kernel.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_base_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="molkgnn-torch-import",
        description="Port a trained reference checkpoint into an exported "
        "model (model shape flags follow `molkgnn-torch`'s)",
    )
    p.add_argument(
        "--torch_ckpt", required=True,
        help="PL .ckpt ({'state_dict': ...}) or raw state_dict torch file",
    )
    p.add_argument(
        "--sdf", required=True,
        help="SDF library the export's batch spec must cover",
    )
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument(
        "--prefix", type=str, default="",
        help="key prefix inside the state_dict (e.g. 'model.')",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    # Peek at --gnn_type ('--gnn_type X' and '--gnn_type=X') to pick the
    # model flag group; the flag itself stays for build_parser.
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--gnn_type", default="kgnn")
    gnn_type = pre.parse_known_args(argv)[0].gnn_type
    args, model_argv = build_base_parser().parse_known_args(argv)
    t0 = time.time()

    from molkgnn_torch.cli.entry import (
        build_model,
        build_parser,
        build_spec,
    )

    margs = build_parser(gnn_type).parse_args(
        model_argv + ["--device", args.device])

    from molkgnn_torch.chem.sdf import parse_sdf
    from molkgnn_torch.serving.predictor import Predictor, resolve_device
    from molkgnn_torch.training.checkpoint import load_torch_checkpoint

    device = resolve_device(args.device)  # raises for cuda without a card
    if gnn_type == "chironet":
        from molkgnn_torch.graphs.chiro import mol_to_chiro_graph as to_graph
    else:
        from molkgnn_torch.chem.features import mol_to_graph as to_graph
    graphs = []
    for i, (mol, _data) in enumerate(parse_sdf(args.sdf)):
        if mol is not None:
            g = to_graph(mol, y=0.0, idx=i)
            if g is not None:
                graphs.append(g)
    if not graphs:
        print("no parseable molecules in --sdf", file=sys.stderr)
        return 2
    margs.batch_size = args.batch_size
    spec = build_spec(margs, graphs)
    model = build_model(margs)
    sd = load_torch_checkpoint(args.torch_ckpt, model, prefix=args.prefix)
    Predictor(model, sd, spec, device=device).export(args.out)
    print(
        f"imported {args.torch_ckpt} ({gnn_type}) -> {args.out} "
        f"(spec covers {len(graphs)} molecules, batch {args.batch_size}, "
        f"{device.type}, {time.time() - t0:.1f}s)"
    )
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
