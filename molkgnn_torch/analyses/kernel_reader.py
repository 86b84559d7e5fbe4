"""Interpretability: decode learned molecular kernels.

Copied from ``molkgnn_tpu/analyses/kernel_reader.py``: load the dumped
layer-0 kernels and translate each kernel's atom/bond feature vectors back
into chemistry: the argmax element of the one-hot blocks, degree,
charge-like scalars, and the dominant bond order per support.

Input: the ``kernels.npz`` written by the port's ``Trainer.save_kernels``
(the CLI writes it under ``logs/kernels/``; keys
``kernelconv{d}/{x_center,x_support,edge_attr_support,p_support,...}``, as
the JAX package's Trainer writes them).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

ELEMENTS = ("H", "C", "N", "O", "F", "Si", "P", "S", "Cl", "Br", "I", "other")
BOND_ORDERS = ("single", "aromatic", "double", "triple")


def decode_atom_vector(v: np.ndarray) -> Dict:
    """28-dim feature vector -> human-readable summary (argmax decoding —
    learned kernels are dense, so this reads the *closest* chemistry)."""
    return {
        "element": ELEMENTS[int(np.argmax(v[:12]))],
        "element_score": float(np.max(v[:12])),
        "degree": int(np.argmax(v[12:16])) + 1,
        "charge": float(v[16]),
        "in_ring": float(v[17]),
        "aromatic": float(v[18]),
        "valence": float(v[19]),
        "mass": float(v[20]),
    }


def decode_bond_vector(v: np.ndarray) -> Dict:
    return {
        "order": BOND_ORDERS[int(np.argmax(v[:4]))],
        "aromatic": float(v[4]),
        "conjugated": float(v[5]),
        "in_ring": float(v[6]),
    }


def decode_kernels(npz_path: str) -> Dict[int, List[Dict]]:
    """Per degree: list of kernels, each with center/supports/bonds decoded."""
    data = np.load(npz_path)
    out: Dict[int, List[Dict]] = {}
    for deg in range(1, 5):
        prefix = f"kernelconv{deg}/"
        if prefix + "x_center" not in data:
            continue
        x_center = data[prefix + "x_center"]
        x_support = data[prefix + "x_support"]
        e_support = data[prefix + "edge_attr_support"]
        p_support = data[prefix + "p_support"]
        kernels = []
        for k in range(x_center.shape[0]):
            kernels.append(
                {
                    "center": decode_atom_vector(x_center[k]),
                    "supports": [
                        decode_atom_vector(x_support[k, i])
                        for i in range(deg)
                    ],
                    "bonds": [
                        decode_bond_vector(e_support[k, i])
                        for i in range(deg)
                    ],
                    "geometry": p_support[k].tolist(),
                }
            )
        out[deg] = kernels
    return out


def interpret_kernel(npz_path: str, deg: int, index: int) -> str:
    """Pretty-print one kernel (the reference's intepret_kernel output)."""
    k = decode_kernels(npz_path)[deg][index]
    lines = [f"kernel deg={deg} #{index}"]
    c = k["center"]
    lines.append(
        f"  center: {c['element']} (deg {c['degree']}, aromatic "
        f"{c['aromatic']:.2f}, ring {c['in_ring']:.2f})"
    )
    for i, (s, b) in enumerate(zip(k["supports"], k["bonds"])):
        lines.append(
            f"  support {i}: {s['element']} via {b['order']} bond "
            f"(conj {b['conjugated']:.2f})"
        )
    return "\n".join(lines)
