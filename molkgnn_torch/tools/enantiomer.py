"""The enantiomer task through the port's CLI, from SDF files it writes.

The port's counterpart of ``benchmarks/quality_run.py``'s ``enantiomer``
task: an AID-1798 SDF pair whose records are mirror-image conformers of 8
chiral scaffolds (one carbon with four substituents of distinct elements),
written with the port's own chemistry (``parse_smiles`` ->
``embed_molecule`` -> mirror -> ``write_sdf``) and labelled by handedness,
so that only chirality separates the classes. The CLI then trains and tests
the 1-layer configuration (hidden 32, no dropout, peak learning rate 1e-2,
warmup 300, batch 32 with oversampling, ``--device_sampling --scan_steps
16``, 20 epochs). Prints one JSON line: the record counts, the ingest time,
the CLI's time, the learning curve and the test metrics beside the JAX-CPU
record (``benchmarks/quality_run/enantiomer/test_result.log``: logAUC
[0.001, 0.1] 0.2167, AUC 0.9005; random floor 0.0215).

    python -m molkgnn_torch.tools.enantiomer                 # on the card
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
# The enantiomer configuration of benchmarks/quality_run.py (ENANT_ARGS and
# its run_task flags).
ENANTIOMER_ARGS = [
    "--num_layers", "1", "--hidden_dim", "32", "--dropout_ratio", "0",
    "--ffn_dropout_rate", "0", "--peak_lr", "1e-2",
    "--warmup_iterations", "300",
]
SAMPLING_ARGS = [
    "--batch_size", "32", "--enable_oversampling_with_replacement",
    "--device_sampling", "--scan_steps", "16",
]
JAX_CPU_RECORD = {"logAUC_0.001_0.1": 0.2167, "AUC": 0.9005}


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


def run(workdir: str, n_inactive: int = N_INACTIVE, epochs: int = 20,
        device: str = "cuda") -> dict:
    """Write the SDF pair under ``workdir``, ingest it, run the CLI; the
    numbers of the run."""
    from molkgnn_torch.cli import entry
    from molkgnn_torch.data.qsar import load_qsar_dataset

    dataset_path = os.path.join(workdir, "dataset")
    root = os.path.join(dataset_path, "qsar", "clean_sdf")
    t0 = time.perf_counter()
    write_enantiomer_sdfs(os.path.join(root, "raw"), N_ACTIVE, n_inactive)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = load_qsar_dataset(root, "1798")
    ingest_s = time.perf_counter() - t0
    out = os.path.join(workdir, "run")
    t0 = time.perf_counter()
    rc = entry.main([
        "--dataset_name", "1798", "--dataset_path", dataset_path,
        "--default_root_dir", out, "--max_epochs", str(epochs),
        "--device", device, *SAMPLING_ARGS, *ENANTIOMER_ARGS,
    ])
    cli_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"the CLI returned {rc}")
    with open(os.path.join(out, "logs", "history.json")) as f:
        history = json.load(f)
    tested = parse_test_result(os.path.join(out, "logs", "test_result.log"))
    return {
        "records": N_ACTIVE + n_inactive,
        "split": {k: len(v) for k, v in ds.split.items()},
        "sdf_write_s": write_s,
        "ingest_s": ingest_s,
        "ingest_s_per_1000": 1e3 * ingest_s / (N_ACTIVE + n_inactive),
        "cli_s": cli_s,
        "train_loss": [e["train_loss"] for e in history],
        "valid_AUC": [e["AUC"] for e in history],
        "valid_logAUC_0.001_0.1": [e["logAUC_0.001_0.1"] for e in history],
        "test": tested,
        "jax_cpu_record": JAX_CPU_RECORD,
        "run_dir": out,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--inactives", type=int, default=N_INACTIVE)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--workdir", default=None,
                   help="where to write the files (default: a temporary "
                        "directory, removed afterwards)")
    args = p.parse_args(argv)
    if args.workdir:
        result = run(args.workdir, args.inactives, args.epochs, args.device)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            result = run(tmp, args.inactives, args.epochs, args.device)
    last = result["test"]["last"]
    print(f"enantiomer: {result['records']} records; test [last] "
          f"logAUC[0.001,0.1] {last['logAUC_0.001_0.1']:.4f}, AUC "
          f"{last['AUC']:.4f} (JAX-CPU record 0.2167 / 0.9005)", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
