"""MolKGNN in plain PyTorch: the reference of the ``kgnn`` family.

Written from the published equations (Liu et al., AAAI-23; the reference
code's ``MolKGNNNet``, ``MolGCN``, ``KernelSetConv``, ``KernelConv``),
imported from nowhere in the program. A batch is the disjoint union of its
molecules, with no padding.

  * Node features pass a BatchNorm (batch statistics in training, the
    running ones in evaluation). The edge features' BatchNorm of the
    reference code feeds nothing, so it is left out: its two leaves get no
    gradient.
  * Each layer scores every node of degree d = 1..4 against L_d kernels.
    A kernel holds a centre feature vector, d support feature vectors, d
    bond feature vectors and d support positions. Over the allowed
    orderings of the supports (all d! for d <= 3, the 12 even ones for
    d = 4) the support score is the mean cosine of neighbour and support
    features; the best ordering (the first of equal maxima) also picks the
    bond score; the centre score is a cosine. The three are mixed by the
    softmax of three score weights. At the last layer a degree-4 score
    flips sign where the signed volume of the neighbours and of the
    kernel's supports at the best ordering differ in sign, unless two
    neighbours carry equal features.
  * Each node's next features are the sum of its neighbours' score rows.
  * Readout: lin2(dropout(swish(lin1(h)))) summed over each molecule's
    nodes, then the head: dropout and one linear layer to a logit.

The length and angle score weights of the reference code never enter a
score: they are leaves with no gradient, as are the support positions,
which only the sign reads.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List

import numpy as np
import torch

from bench_port.reference.common import concat_offsets, linear

EVEN_4 = ((0, 1, 2, 3), (0, 2, 3, 1), (0, 3, 1, 2), (1, 0, 3, 2),
          (1, 2, 0, 3), (1, 3, 2, 0), (2, 0, 1, 3), (2, 1, 3, 0),
          (2, 3, 0, 1), (3, 0, 2, 1), (3, 1, 0, 2), (3, 2, 1, 0))
PERMS = {d: (EVEN_4 if d == 4 else tuple(itertools.permutations(range(d))))
         for d in range(1, 5)}
SCORE_WEIGHTS = ("length_sc_weight", "angle_sc_weight",
                 "center_attr_sc_weight", "support_attr_sc_weight",
                 "edge_attr_support_sc_weight")
EPS = 1e-12


def _widths(enc: dict, layer: int) -> List[int]:
    return list(enc["kernels_1hop"] if layer == 0 else enc["kernels_nhop"])


def param_specs(cfg: dict):
    """[(name, shape, init)] of every leaf, named as the reference
    checkpoint names them."""
    enc = cfg["encoder"]
    f, fe, pd = enc["node_dim"], enc["edge_dim"], enc.get("pos_dim", 3)
    hid = enc["graph_embedding_dim"]
    specs = []
    for bn, width in (("node_batch_norm", f), ("edge_batch_norm", fe)):
        specs += [(f"gnn_model.{bn}.weight", (width,), ("const", 1.0)),
                  (f"gnn_model.{bn}.bias", (width,), ("const", 0.0))]
    in_dim = f
    for i in range(enc["num_layers"]):
        widths = _widths(enc, i)
        for d, nk in enumerate(widths, 1):
            pre = f"gnn_model.gnn.layers.{i}.trainable_kernelconv_set.{d - 1}"
            specs += [
                (f"{pre}.x_center", (nk, in_dim), ("normal", 1.0)),
                (f"{pre}.x_support", (nk, d, in_dim), ("normal", 1.0)),
                # One bond vector for all of a kernel's slots: every
                # ordering then gives the same bond score, so orderings tied
                # on the support score (neighbours with equal features)
                # give the same forward whichever one is picked.
                (f"{pre}.edge_attr_support", (nk, d, fe),
                 ("normal_rows", 1.0)),
                (f"{pre}.p_support", (nk, d, pd), ("normal", 1.0)),
            ]
            specs += [(f"{pre}.{w}", (), ("const", 0.2))
                      for w in SCORE_WEIGHTS]
        in_dim = sum(widths)
    for name, (i, o) in (("graph_embedding_lin1", (in_dim, hid)),
                         ("graph_embedding_lin2", (hid, hid))):
        bound = 1.0 / math.sqrt(i)
        specs += [(f"gnn_model.{name}.weight", (o, i), ("uniform", bound)),
                  (f"gnn_model.{name}.bias", (o,), ("uniform", bound))]
    bound = 1.0 / math.sqrt(hid)
    specs += [("ffn.weight", (1, hid), ("uniform", bound)),
              ("ffn.bias", (1,), ("uniform", bound))]
    return specs


NODE_BN = "gnn_model.node_batch_norm"


def initial_stats(cfg: dict) -> Dict[str, torch.Tensor]:
    """The statistics a model starts from, by the program's names: the
    node BatchNorm's running mean 0 and variance 1."""
    width = cfg["encoder"]["node_dim"]
    return {f"{NODE_BN}.running_mean": torch.zeros(width),
            f"{NODE_BN}.running_var": torch.ones(width)}


def eval_stats(state: Dict[str, torch.Tensor], device):
    """What the evaluation forward normalises by (``bn_stats``): the node
    BatchNorm's running mean and variance in ``state``."""
    return (state[f"{NODE_BN}.running_mean"].to(device),
            state[f"{NODE_BN}.running_var"].to(device))


def embedding_width(cfg: dict) -> int:
    return cfg["encoder"]["graph_embedding_dim"]


def counts(mol, cfg: dict) -> Dict[str, int]:
    """A molecule's own counts: nodes, directed edges, nodes of each
    degree."""
    n = mol.x.shape[0]
    deg = np.bincount(mol.edge_index[0], minlength=n)
    out = {"nodes": n, "edges": int(mol.edge_index.shape[1])}
    for d in range(1, 5):
        out[f"deg{d}"] = int((deg == d).sum())
    return out


def inputs(molecules, mol_ids, labels, device, cfg: dict,
           dtype=torch.float32):
    """The batch of ``molecules[mol_ids]`` (in that order) as tensors on
    ``device``: features, positions, molecule of each node, directed
    edges, and each degree's focal nodes, neighbours (in edge-list order)
    and the bond features of each neighbour's bond (its first
    direction)."""
    mols = [molecules[int(k)] for k in mol_ids]
    n = [m.x.shape[0] for m in mols]
    off = concat_offsets(n)
    src = np.concatenate([m.edge_index[0] + o for m, o in zip(mols, off)])
    dst = np.concatenate([m.edge_index[1] + o for m, o in zip(mols, off)])
    eattr = np.concatenate([m.edge_attr for m in mols])
    total = int(sum(n))
    deg = np.bincount(src, minlength=total)
    order = np.argsort(src, kind="stable")
    first = np.cumsum(deg) - deg
    # Bond b's directions are edges 2b and 2b + 1 (every molecule has an
    # even number of edges, so this holds across the union).
    bond_attr = eattr[2 * (order // 2)]

    def dev(a, t=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=t)

    buckets = []
    for d in range(1, 5):
        focal = np.nonzero(deg == d)[0]
        take = first[focal][:, None] + np.arange(d)[None, :]
        buckets.append({"focal": dev(focal, torch.long),
                        "nei": dev(dst[order][take], torch.long),
                        "ea": dev(bond_attr[take], dtype)})
    return {
        "x": dev(np.concatenate([m.x for m in mols]), dtype),
        "p": dev(np.concatenate([m.p for m in mols]), dtype),
        "graph": dev(np.repeat(np.arange(len(mols)), n), torch.long),
        "src": dev(src, torch.long),
        "dst": dev(dst, torch.long),
        "buckets": buckets,
        "y": dev(np.asarray(labels), dtype),
        "num_graphs": len(mols),
    }


def _normalize(t: torch.Tensor) -> torch.Tensor:
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                           min=EPS)


def _det(a, b, c):
    return (c * torch.linalg.cross(a, b, dim=-1)).sum(-1)


def _conv(prm, pre, d, h, pos, bucket, last):
    """[M, L] scores of the degree-d nodes of ``bucket``, and the gap
    between each row's best and second-best support score (inf at one
    ordering)."""
    perms = torch.tensor(PERMS[d], device=h.device)
    xc, xs = prm[f"{pre}.x_center"], prm[f"{pre}.x_support"]
    es, ps = prm[f"{pre}.edge_attr_support"], prm[f"{pre}.p_support"]
    nk, np_ = xc.shape[0], perms.shape[0]
    focal, nei, ea = bucket["focal"], bucket["nei"], bucket["ea"]
    m = focal.shape[0]
    x_nei = h[nei]  # [M, d, F]
    a = _normalize(x_nei).reshape(m, d * h.shape[1])
    b = _normalize(xs[:, perms]).reshape(nk * np_, -1)
    sup = (a @ b.T / d).reshape(m, nk, np_)
    best_idx = torch.argmax(sup, dim=2, keepdim=True)  # first maximum
    best = torch.gather(sup, 2, best_idx)[..., 0]
    if np_ > 1:
        top2 = torch.topk(sup.detach(), 2, dim=2).values
        gap = top2[..., 0] - top2[..., 1]
    else:
        gap = torch.full_like(best.detach(), math.inf)
    e = _normalize(ea).reshape(m, d * es.shape[2])
    eb = _normalize(es[:, perms]).reshape(nk * np_, -1)
    edge_all = (e @ eb.T / d).reshape(m, nk, np_)
    edge = torch.gather(edge_all, 2, best_idx)[..., 0]
    center = _normalize(h[focal]) @ _normalize(xc).T
    w = torch.softmax(torch.stack([prm[f"{pre}.support_attr_sc_weight"],
                                   prm[f"{pre}.center_attr_sc_weight"],
                                   prm[f"{pre}.edge_attr_support_sc_weight"]
                                   ]), 0)
    sc = best * w[0] + center * w[1] + edge * w[2]
    if d == 4 and last:
        with torch.no_grad():
            pc = pos[nei] - pos[focal][:, None, :]
            det_nei = _det(pc[:, 0], pc[:, 1], pc[:, 2])
            s = ps[:, perms]  # [L, P, 4, 3]
            det_sup = _det(s[:, :, 0], s[:, :, 1], s[:, :, 2])  # [L, P]
            kid = torch.arange(nk, device=h.device)[None, :]
            det_best = det_sup[kid, best_idx[..., 0]]
            match = torch.sign(det_nei)[:, None] == torch.sign(det_best)
            equal = torch.zeros(m, dtype=torch.bool, device=h.device)
            for i, j in itertools.combinations(range(4), 2):
                equal |= (x_nei[:, i] == x_nei[:, j]).all(-1)
            sign = torch.where(equal[:, None] | match, 1.0, -1.0)
        sc = sc * sign.to(sc.dtype)
    return sc, gap


def forward(prm: Dict[str, torch.Tensor], inp: dict, cfg: dict, train: bool,
            head_keep=None, bn_stats=None):
    """(logits [B], margin [B]): ``margin`` is each molecule's least gap
    between its best and second-best support score over every node,
    kernel and layer (inf where every scored node has one ordering).

    ``head_keep``: the head dropout's factor [B, H] in training;
    ``bn_stats``: (running mean, running variance) in evaluation.
    """
    enc = cfg["encoder"]
    if enc.get("drop_ratio", 0.0) != 0.0 or enc.get("fixed_kernels"):
        raise ValueError("the kgnn reference has no encoder dropout and no "
                         "fixed kernel sets")
    x = inp["x"]
    w, b = prm["gnn_model.node_batch_norm.weight"], \
        prm["gnn_model.node_batch_norm.bias"]
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
    else:
        mean, var = bn_stats
    h = (x - mean) / torch.sqrt(var + 1e-5) * w + b
    nl = enc["num_layers"]
    margin_node = torch.full((x.shape[0],), math.inf, device=x.device,
                             dtype=x.dtype)
    for i in range(nl):
        widths = _widths(enc, i)
        blocks = []
        for d, (nk, bucket) in enumerate(zip(widths, inp["buckets"]), 1):
            pre = f"gnn_model.gnn.layers.{i}.trainable_kernelconv_set.{d - 1}"
            sc, gap = _conv(prm, pre, d, h, inp["p"], bucket, i == nl - 1)
            block = sc.new_zeros((x.shape[0], nk))
            blocks.append(block.index_copy(0, bucket["focal"], sc))
            if gap.numel():
                margin_node = margin_node.scatter_reduce(
                    0, bucket["focal"], gap.min(1).values.to(x.dtype),
                    "amin")
        out = torch.cat(blocks, 1)
        h = out.new_zeros(out.shape).index_add(0, inp["dst"],
                                               out[inp["src"]])
    g = "gnn_model.graph_embedding_"
    h = linear(h, prm[g + "lin1.weight"], prm[g + "lin1.bias"])
    h = linear(h * torch.sigmoid(h), prm[g + "lin2.weight"],
               prm[g + "lin2.bias"])
    nb = inp["num_graphs"]
    emb = h.new_zeros((nb, h.shape[1])).index_add(0, inp["graph"], h)
    if train and head_keep is not None:
        emb = emb * head_keep
    logits = linear(emb, prm["ffn.weight"], prm["ffn.bias"])[:, 0]
    margin = torch.full((nb,), math.inf, device=x.device, dtype=x.dtype)
    margin = margin.scatter_reduce(0, inp["graph"], margin_node, "amin")
    return logits, margin


def scorer_shapes(cfg: dict, c: Dict[str, float]):
    """Per layer, the scorer's groups (M, K, L, P) at the node counts
    ``c`` (``deg1``..``deg4`` of a whole batch)."""
    enc = cfg["encoder"]
    layers, in_dim = [], enc["node_dim"]
    for i in range(enc["num_layers"]):
        widths = _widths(enc, i)
        layers.append([(c[f"deg{d}"], d * in_dim, nk, len(PERMS[d]))
                       for d, nk in enumerate(widths, 1)])
        in_dim = sum(widths)
    return layers


def model_flops(cfg: dict, c: Dict[str, float]) -> float:
    """Operations (2 a multiply-add) of the products and similarity
    reductions of one train step at the batch counts ``c``: forward, every
    ordering's support and bond scores, the centre scores, the readout
    and head products; backward, the support and bond scores through the
    best ordering only (the support's two operands, the bond supports'
    one: bond features are data), the centre scores' two operands, and
    twice each readout and head product (layer 0's input included: the
    node BatchNorm's leaves need it)."""
    enc = cfg["encoder"]
    fe = enc["edge_dim"]
    total, in_dim = 0.0, enc["node_dim"]
    for layer in scorer_shapes(cfg, c):
        for m, k, nk, np_ in layer:
            d = k // in_dim
            fwd = 2 * m * k * nk * np_ + 2 * m * d * fe * nk * np_ \
                + 2 * m * in_dim * nk
            bwd = 4 * m * k * nk + 2 * m * d * fe * nk + 4 * m * in_dim * nk
            total += fwd + bwd
        in_dim = sum(nk for _, _, nk, _ in layer)
    hid = enc["graph_embedding_dim"]
    head = 2 * c["nodes"] * (in_dim * hid + hid * hid) + 2 * c["graphs"] * hid
    return total + 3 * head
