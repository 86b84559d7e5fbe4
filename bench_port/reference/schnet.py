"""SchNet in plain PyTorch: the reference of the ``schnet`` family.

Written from the published equations (Schuett et al., NeurIPS 2017) in
the DIG (3DGN) form that the MolKGNN reference code uses, imported from
nowhere in the program. A batch is the disjoint union of its molecules.

  * The graph is every ordered pair of distinct atoms of a molecule closer
    than the cutoff.
  * Each pair's distance is expanded in ``num_gaussians`` Gaussians
    exp(-(d - mu_k)^2 / (2 delta^2)), mu on a uniform grid over [0,
    cutoff], delta its spacing, and gated by 0.5 (cos(pi d / cutoff) + 1).
  * An atom starts from the embedding of its atomic number. Each
    interaction: filter W = lin(ssp(lin(rbf))) * gate; message (lin(v) at
    the source) * W summed at the target; v += lin(ssp(lin(sum))).
  * Readout: lin(ssp(lin(v))) summed over each molecule, then the head:
    dropout and one linear layer to a logit. ssp(x) = ln(1 + e^x) - ln 2.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from bench_port.reference.common import concat_offsets, linear


def _ssp(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x)) - math.log(2.0)


def param_specs(cfg: dict):
    """[(name, shape, init)]: xavier-uniform weights, zero biases, the
    embedding N(0, 1); the head's layer U(+-1/sqrt(in))."""
    enc = cfg["encoder"]
    h, nf, ng = enc["hidden_channels"], enc["num_filters"], \
        enc["num_gaussians"]
    out = enc["out_channels"]

    def lin(name, i, o, bias=True):
        a = math.sqrt(6.0 / (i + o))
        s = [(f"{name}.weight", (o, i), ("uniform", a))]
        return s + ([(f"{name}.bias", (o,), ("const", 0.0))] if bias else [])

    g = "gnn_model"
    specs = [(f"{g}.init_v.weight", (100, h), ("normal", 1.0))]
    for i in range(enc["num_layers"]):
        specs += lin(f"{g}.update_es.{i}.mlp.0", ng, nf)
        specs += lin(f"{g}.update_es.{i}.mlp.2", nf, nf)
        specs += lin(f"{g}.update_es.{i}.lin", h, nf, bias=False)
    for i in range(enc["num_layers"]):
        specs += lin(f"{g}.update_vs.{i}.lin1", nf, h)
        specs += lin(f"{g}.update_vs.{i}.lin2", h, h)
    specs += lin(f"{g}.update_u.lin1", h, h // 2)
    specs += lin(f"{g}.update_u.lin2", h // 2, out)
    bound = 1.0 / math.sqrt(out)
    specs += [("ffn.weight", (1, out), ("uniform", bound)),
              ("ffn.bias", (1,), ("uniform", bound))]
    return specs


def initial_stats(cfg: dict) -> Dict[str, torch.Tensor]:
    """The statistics a model starts from: SchNet keeps none."""
    return {}


def eval_stats(state: Dict[str, torch.Tensor], device):
    """What the evaluation forward normalises by: nothing."""
    return None


def embedding_width(cfg: dict) -> int:
    return cfg["encoder"]["out_channels"]


def _pairs(pos: np.ndarray, cutoff: float):
    d = np.linalg.norm(pos[None, :, :] - pos[:, None, :], axis=-1)
    close = (d < cutoff) & ~np.eye(pos.shape[0], dtype=bool)
    tgt, src = np.nonzero(close)
    return src, tgt


def counts(mol, cfg: dict) -> Dict[str, int]:
    """A molecule's own counts: atoms and ordered pairs within the
    cutoff."""
    src, _ = _pairs(mol.p, float(cfg["encoder"]["cutoff"]))
    return {"nodes": int(mol.p.shape[0]), "pairs": int(src.shape[0])}


def inputs(molecules, mol_ids, labels, device, cfg: dict,
           dtype=torch.float32):
    """The batch of ``molecules[mol_ids]`` as tensors on ``device``."""
    mols = [molecules[int(k)] for k in mol_ids]
    n = [m.p.shape[0] for m in mols]
    off = concat_offsets(n)
    src, tgt = [], []
    cutoff = float(cfg["encoder"]["cutoff"])
    for m, o in zip(mols, off):
        s, t = _pairs(m.p, cutoff)
        src.append(s + o)
        tgt.append(t + o)

    def dev(a, t):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                             dtype=t)

    return {
        "z": dev(np.concatenate([m.atomic_num for m in mols]), torch.long),
        "pos": dev(np.concatenate([m.p for m in mols]), dtype),
        "graph": dev(np.repeat(np.arange(len(mols)), n), torch.long),
        "src": dev(np.concatenate(src), torch.long),
        "dst": dev(np.concatenate(tgt), torch.long),
        "y": dev(np.asarray(labels), dtype),
        "num_graphs": len(mols),
    }


def forward(prm: Dict[str, torch.Tensor], inp: dict, cfg: dict, train: bool,
            head_keep=None, bn_stats=None):
    """(logits [B], margin [B]); SchNet takes no argmax, so every margin is
    inf."""
    enc = cfg["encoder"]
    cutoff, ng = float(enc["cutoff"]), enc["num_gaussians"]
    g = "gnn_model"
    src, dst = inp["src"], inp["dst"]
    pos = inp["pos"]
    dist = torch.linalg.norm(pos[src] - pos[dst], dim=-1)
    grid = np.linspace(0.0, cutoff, ng)
    mu = torch.tensor(grid, dtype=torch.float64, device=pos.device).to(
        pos.dtype)
    coeff = -0.5 / float(grid[1] - grid[0]) ** 2
    rbf = torch.exp(coeff * (dist[:, None] - mu[None, :]) ** 2)
    gate = 0.5 * (torch.cos(dist * math.pi / cutoff) + 1.0)
    emb = prm[f"{g}.init_v.weight"]
    v = emb[torch.clamp(inp["z"], 0, emb.shape[0] - 1)]
    for i in range(enc["num_layers"]):
        e = f"{g}.update_es.{i}"
        w = linear(_ssp(linear(rbf, prm[f"{e}.mlp.0.weight"],
                               prm[f"{e}.mlp.0.bias"])),
                   prm[f"{e}.mlp.2.weight"], prm[f"{e}.mlp.2.bias"])
        msg = linear(v, prm[f"{e}.lin.weight"])[src] * (w * gate[:, None])
        agg = msg.new_zeros((v.shape[0], msg.shape[1])).index_add(0, dst,
                                                                  msg)
        u = f"{g}.update_vs.{i}"
        v = v + linear(_ssp(linear(agg, prm[f"{u}.lin1.weight"],
                                   prm[f"{u}.lin1.bias"])),
                       prm[f"{u}.lin2.weight"], prm[f"{u}.lin2.bias"])
    u = f"{g}.update_u"
    out = linear(_ssp(linear(v, prm[f"{u}.lin1.weight"],
                             prm[f"{u}.lin1.bias"])),
                 prm[f"{u}.lin2.weight"], prm[f"{u}.lin2.bias"])
    nb = inp["num_graphs"]
    pooled = out.new_zeros((nb, out.shape[1])).index_add(0, inp["graph"],
                                                         out)
    if train and head_keep is not None:
        pooled = pooled * head_keep
    logits = linear(pooled, prm["ffn.weight"], prm["ffn.bias"])[:, 0]
    return logits, torch.full((nb,), math.inf, device=pos.device,
                              dtype=pos.dtype)


def model_flops(cfg: dict, c: Dict[str, float]) -> float:
    """Operations (2 a multiply-add) of one train step's products at the
    batch counts ``c`` (``pairs``, ``nodes``, ``graphs``): each
    interaction's filter network over the pairs and its three node
    products, the readout and the head, forward and backward; the
    backward of a product is twice its forward, but for the filter's first
    layer, whose input (the distance expansion) is data and needs no
    gradient."""
    enc = cfg["encoder"]
    h, nf, ng = enc["hidden_channels"], enc["num_filters"], \
        enc["num_gaussians"]
    e, n, b = c["pairs"], c["nodes"], c["graphs"]
    rbf = 2 * e * ng * nf
    rest = 2 * e * nf * nf + 2 * n * (h * nf + nf * h + h * h)
    per_layer = 2 * rbf + 3 * rest
    readout = 2 * n * (h * (h // 2) + (h // 2) * enc["out_channels"]) \
        + 2 * b * enc["out_channels"]
    return enc["num_layers"] * per_layer + 3 * readout
