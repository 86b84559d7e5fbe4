"""The enantiomer task through the port's CLI, from SDF files it writes.

The port's counterpart of ``benchmarks/quality_run.py``'s ``enantiomer``
task: an AID-1798 SDF pair whose records are mirror-image conformers of 8
chiral scaffolds (one carbon with four substituents of distinct elements),
written with the port's own chemistry (``parse_smiles`` ->
``embed_molecule`` -> mirror -> ``write_sdf``) and labelled by handedness,
so that only chirality separates the classes. The CLI then trains and tests
``--gnn_type``'s configuration of ``benchmarks/quality_run.py``, at batch 32
with oversampling, ``--device_sampling --scan_steps 16`` and warmup 300:
kgnn 1 layer (hidden 32, no dropout, peak learning rate 1e-2, 20 epochs);
SchNet 3 layers, hidden 32 (6 epochs) and DimeNet++ 2 blocks, hidden 32 (6
epochs), the two mirror-invariant null controls; SphereNet 2 layers, hidden
32 (12 epochs), whose torsion sees handedness; ChIRoNet F_H 32, 2 GAT heads
(6 epochs), whose R/S node tags and torsion phases see it. Prints one JSON
line: the record counts, the ingest time, the CLI's time, the learning
curve and the test metrics beside the JAX-CPU record
(``benchmarks/quality_run/enantiomer{,_schnet,_dimenet_pp,_spherenet,
_chironet}/test_result.log``, ``[last]``; random floor 0.0215). One of the
8 scaffolds, FC(Cl)Br, has no dihedral: ChIRoNet's ingest drops its
records, as the JAX package's does.

    python -m molkgnn_torch.tools.enantiomer                 # on the card
    python -m molkgnn_torch.tools.enantiomer --gnn_type spherenet
    python -m molkgnn_torch.tools.enantiomer --gnn_type chironet
    python -m molkgnn_torch.tools.enantiomer --inactives 6000 --device cpu
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import time

import numpy as np

# AID 1798's record counts (the reference's data_split.py).
N_ACTIVE, N_INACTIVE = 187, 61645
CHIRAL_SMILES = ["FC(Cl)Br", "CC(F)Cl", "CC(N)O", "NC(F)Cl",
                 "CC(O)F", "OC(F)Cl", "CC(Br)Cl", "CC(N)F"]
# The enantiomer configurations of benchmarks/quality_run.py (ENANT_ARGS,
# SCHNET_ARGS, DIMENET_ARGS, SPHERENET_ARGS, CHIRONET_ARGS), their epochs
# (TASKS) and the JAX-CPU records ([last] of each task's test_result.log),
# by gnn_type.
CONFIGS = {
    "kgnn": ([
        "--num_layers", "1", "--hidden_dim", "32", "--dropout_ratio", "0",
        "--ffn_dropout_rate", "0", "--peak_lr", "1e-2",
    ], 20, {"logAUC_0.001_0.1": 0.2167, "AUC": 0.9005}),
    "schnet": ([
        "--num_layers", "3", "--hidden_channels", "32", "--num_filters",
        "32", "--num_gaussians", "25", "--out_channels", "16",
        "--ffn_dropout_rate", "0.0", "--peak_lr", "1e-3",
    ], 6, {"logAUC_0.001_0.1": 0.0, "AUC": 0.2900}),
    "dimenet_pp": ([
        "--cutoff", "5.0", "--num_blocks", "2", "--hidden_channels", "32",
        "--out_channels", "16", "--int_emb_size", "16", "--basis_emb_size",
        "8", "--out_emb_channels", "32", "--num_spherical", "3",
        "--num_radial", "4", "--num_before_skip", "1", "--num_after_skip",
        "1", "--num_output_layers", "1", "--ffn_dropout_rate", "0.0",
        "--peak_lr", "1e-3",
    ], 6, {"logAUC_0.001_0.1": 0.0, "AUC": 0.1201}),
    "spherenet": ([
        "--cutoff", "5.0", "--num_layers", "2", "--hidden_channels", "32",
        "--out_channels", "16", "--int_emb_size", "16",
        "--basis_emb_size_dist", "8", "--basis_emb_size_angle", "8",
        "--basis_emb_size_torsion", "8", "--out_emb_channels", "32",
        "--num_spherical", "3", "--num_radial", "4", "--num_before_skip",
        "1", "--num_after_skip", "1", "--num_output_layers", "1",
        "--ffn_dropout_rate", "0.0", "--peak_lr", "2e-3",
    ], 12, {"logAUC_0.001_0.1": 0.2250, "AUC": 0.6422}),
    "chironet": ([
        "--F_H", "32", "--F_H_EConv", "32", "--GAT_N_heads", "2",
        "--dropout", "0.0", "--ffn_dropout_rate", "0.0", "--peak_lr", "1e-3",
    ], 6, {"logAUC_0.001_0.1": 0.2296, "AUC": 0.9030}),
}
# The kgnn configuration (chip_smoke.py phase 6 runs it).
ENANTIOMER_ARGS = CONFIGS["kgnn"][0] + ["--warmup_iterations", "300"]
JAX_CPU_RECORD = CONFIGS["kgnn"][2]
SAMPLING_ARGS = [
    "--batch_size", "32", "--enable_oversampling_with_replacement",
    "--device_sampling", "--scan_steps", "16",
]


def chiral_pair(smi: str, seed: int):
    """(plus, minus): a conformer of ``smi`` turned to + handedness at its
    stereocentre (the sign of the triple product of the substituents in
    atomic-number order), and its mirror image. Mirroring keeps every
    distance and angle, so the label follows chirality and nothing else."""
    from molkgnn_torch.chem import periodic
    from molkgnn_torch.chem.embed import embed_molecule
    from molkgnn_torch.chem.smiles import parse_smiles

    mol = parse_smiles(smi, add_hs=True)
    pos = np.asarray(embed_molecule(mol, seed=seed, iterations=60), float)
    order = None
    for i in range(mol.num_atoms):
        nb = [a for a, _ in mol.neighbors(i)]
        zs = [periodic.atomic_number(mol.atoms[a].symbol) for a in nb]
        if len(nb) == 4 and len(set(zs)) == 4:
            order = [a for _, a in sorted(zip(zs, nb))]
            break
    if order is None:
        raise ValueError(f"no unambiguous stereocentre in {smi}")
    a, b, c, d = (pos[j] for j in order)
    flip = np.array([-1.0, 1.0, 1.0])
    if float(np.dot(np.cross(b - a, c - a), d - a)) < 0:
        pos = pos * flip
    out = []
    for p in (pos, pos * flip):
        m = copy.deepcopy(mol)
        for atom, xyz in zip(m.atoms, p):
            atom.x, atom.y, atom.z = map(float, xyz)
        out.append(m)
    return out


def write_enantiomer_sdfs(raw: str, n_active: int = N_ACTIVE,
                          n_inactive: int = N_INACTIVE):
    """Write ``1798_{actives,inactives}_new.sdf`` under ``raw``: 200 mirror
    pairs, actives + handed and inactives their mirror images, each file
    cycling through its 200 conformers."""
    from molkgnn_torch.chem.sdf import write_sdf

    os.makedirs(raw, exist_ok=True)
    pairs = [chiral_pair(CHIRAL_SMILES[i % len(CHIRAL_SMILES)], seed=i)
             for i in range(200)]
    for name, n, side in (("actives", n_active, 0),
                          ("inactives", n_inactive, 1)):
        write_sdf(os.path.join(raw, f"1798_{name}_new.sdf"),
                  [pairs[i % 200][side] for i in range(n)])


def parse_test_result(path: str):
    """{tag: {metric: value}} of a test_result.log."""
    out, tag = {}, None
    with open(path) as f:
        for line in f.read().splitlines():
            if line.startswith("[") and line.endswith("]"):
                tag = line[1:-1]
                out[tag] = {}
            elif ":" in line and tag is not None:
                k, v = line.split(":", 1)
                out[tag][k.strip()] = float(v)
    return out


def cli_run(dataset_path: str, out: str, gnn_type: str = "kgnn",
            epochs: int | None = None, device: str = "cuda") -> dict:
    """Train and test ``gnn_type``'s configuration (``epochs`` None: its
    own count) through the CLI on the AID-1798 pair under
    ``dataset_path``, into ``out``; its history and test metrics."""
    from molkgnn_torch.cli import entry

    flags, own_epochs, record = CONFIGS[gnn_type]
    epochs = own_epochs if epochs is None else epochs
    t0 = time.perf_counter()
    rc = entry.main([
        "--dataset_name", "1798", "--dataset_path", dataset_path,
        "--default_root_dir", out, "--max_epochs", str(epochs),
        "--device", device, "--gnn_type", gnn_type, *SAMPLING_ARGS,
        *flags, "--warmup_iterations", "300",
    ])
    cli_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"the CLI returned {rc}")
    with open(os.path.join(out, "logs", "history.json")) as f:
        history = json.load(f)
    return {
        "gnn_type": gnn_type,
        "epochs": epochs,
        "cli_s": cli_s,
        "train_loss": [e["train_loss"] for e in history],
        "valid_AUC": [e["AUC"] for e in history],
        "valid_logAUC_0.001_0.1": [e["logAUC_0.001_0.1"] for e in history],
        "test": parse_test_result(os.path.join(out, "logs",
                                               "test_result.log")),
        "jax_cpu_record": record,
        "run_dir": out,
    }


def run(workdir: str, n_inactive: int = N_INACTIVE,
        epochs: int | None = None, device: str = "cuda",
        gnn_type: str = "kgnn") -> dict:
    """Write the SDF pair under ``workdir``, ingest it, run the CLI
    (``cli_run``); the numbers of the run."""
    from molkgnn_torch.data.qsar import load_qsar_dataset

    dataset_path = os.path.join(workdir, "dataset")
    root = os.path.join(dataset_path, "qsar", "clean_sdf")
    t0 = time.perf_counter()
    write_enantiomer_sdfs(os.path.join(root, "raw"), N_ACTIVE, n_inactive)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = load_qsar_dataset(root, "1798", gnn_type=gnn_type)
    ingest_s = time.perf_counter() - t0
    result = cli_run(dataset_path, os.path.join(workdir, "run"), gnn_type,
                     epochs, device)
    return {
        "records": N_ACTIVE + n_inactive,
        "split": {k: len(v) for k, v in ds.split.items()},
        "sdf_write_s": write_s,
        "ingest_s": ingest_s,
        "ingest_s_per_1000": 1e3 * ingest_s / (N_ACTIVE + n_inactive),
        **result,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--inactives", type=int, default=N_INACTIVE)
    p.add_argument("--gnn_type", choices=sorted(CONFIGS), default="kgnn")
    p.add_argument("--epochs", type=int, default=None,
                   help="default: the configuration's own count")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--workdir", default=None,
                   help="where to write the files (default: a temporary "
                        "directory, removed afterwards)")
    args = p.parse_args(argv)
    if args.workdir:
        result = run(args.workdir, args.inactives, args.epochs, args.device,
                     args.gnn_type)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            result = run(tmp, args.inactives, args.epochs, args.device,
                         args.gnn_type)
    last, rec = result["test"]["last"], result["jax_cpu_record"]
    print(f"enantiomer {args.gnn_type}: {result['records']} records; test "
          f"[last] logAUC[0.001,0.1] {last['logAUC_0.001_0.1']:.4f}, AUC "
          f"{last['AUC']:.4f} (JAX-CPU record {rec['logAUC_0.001_0.1']:.4f}"
          f" / {rec['AUC']:.4f})", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
