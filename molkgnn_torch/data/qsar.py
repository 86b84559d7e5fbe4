"""QSAR (PubChem HTS) dataset ingest: SDF -> featurized MolGraphs + splits.

Reference contract: QSARDataset (reference wrapper.py:351-556) + split
artifacts (utils/data_split.py). Nine assay IDs + the AID-9999 smoke set;
actives/inactives SDF pairs named ``{AID}_actives_new.sdf`` /
``{AID}_inactives_new.sdf`` under ``root/raw``; invalid molecules are logged
as (counter, label) and removed from every split part (wrapper.py:509-531,
with a loud warning when an active is dropped).

Processed caches are a single ``.npz`` per (dataset, backend) — node/edge
arrays concatenated with per-molecule counts; receptive fields are
recomputed on load by the vectorized builder (cheap).

Copy of ``molkgnn_tpu/data/qsar.py``: the same splits and the same ingest.
The MolGraph featurization (the kgnn family, which the 3D point-cloud
families share) has the same cache files, so each package reads the
other's. ChIRoNet (``gnn_type="chironet"``) featurizes with
``graphs/chiro.py::mol_to_chiro_graph`` and drops the molecules with no
dihedral, as the JAX package does; its cache is the port's own
(``chironet-{AID}-3D-{backend}.npz``: flat arrays with per-molecule counts,
no pickle), never the JAX package's pickled ``.npy`` of its own objects.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from molkgnn_torch.chem.features import mol_to_graph
from molkgnn_torch.chem.sdf import parse_sdf
from molkgnn_torch.data.dataset import Dataset, QSAR_METRICS
from molkgnn_torch.graphs.molgraph import MolGraph

DATASET_INFO = {
    "435008": {"num_active": 233, "num_inactive": 217923},
    "1798": {"num_active": 187, "num_inactive": 61645},
    "435034": {"num_active": 362, "num_inactive": 61393},
    "1843": {"num_active": 172, "num_inactive": 301318},
    "2258": {"num_active": 213, "num_inactive": 302189},
    "463087": {"num_active": 703, "num_inactive": 100171},
    "488997": {"num_active": 252, "num_inactive": 302051},
    "2689": {"num_active": 172, "num_inactive": 319617},
    "485290": {"num_active": 278, "num_inactive": 341026},
    "9999": {"num_active": 37, "num_inactive": 226},
}


# ---------------------------------------------------------------------------
# Splits
# ---------------------------------------------------------------------------
def make_split(
    num_active: int,
    num_inactive: int,
    seed: int,
    shrink: bool = False,
) -> Dict[str, List[int]]:
    """Stratified 80/10/10 split, reproducing utils/data_split.py:6-56
    exactly (python ``random`` shuffles, rounding, 10k shrink cap) so splits
    are bit-identical to the shipped artifacts for the same seed."""
    active_idx = list(range(num_active))
    inactive_idx = list(range(num_active, num_active + num_inactive))
    random.seed(seed)
    random.shuffle(active_idx)
    random.shuffle(inactive_idx)

    n_at = round(num_active * 0.8)
    n_it = (
        (10000 if num_inactive > 10000 else round(num_inactive * 0.8))
        if shrink
        else round(num_inactive * 0.8)
    )
    n_av = round(num_active * 0.1)
    n_iv = round(num_inactive * 0.1)
    n_ate = num_active - n_at - n_av
    n_ite = round(num_inactive * 0.1)

    return {
        "train": active_idx[:n_at] + inactive_idx[:n_it],
        "valid": active_idx[n_at : n_at + n_av]
        + inactive_idx[n_it : n_it + n_iv],
        "test": active_idx[n_at + n_av : n_at + n_av + n_ate]
        + inactive_idx[n_it + n_iv : n_it + n_iv + n_ite],
    }


def split_checksum(split: Dict[str, List[int]]) -> str:
    """MD5 over the JSON split dict (utils/data_split.py:59-63)."""
    return hashlib.md5(
        json.dumps(split, sort_keys=True).encode("utf-8")
    ).hexdigest()


def save_split(
    split: Dict[str, List[int]], path: str, torch_format: bool = True
) -> str:
    """Persist a split + its MD5 ``.checksum`` sidecar (the reference's
    artifact layout, utils/data_split.py:58-63). ``torch_format`` writes a
    torch pickle readable by the reference; otherwise an npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if torch_format:
        import torch

        torch.save(split, path)
    else:
        np.savez(path, **{k: np.asarray(v) for k, v in split.items()})
    digest = split_checksum(split)
    with open(path + ".checksum", "w") as f:
        f.write(digest)
    return digest


def load_reference_split(path: str) -> Dict[str, List[int]]:
    """Load a shipped ``data_split/*.pt`` artifact (torch pickle)."""
    import torch

    split = torch.load(path, weights_only=False)
    return {k: list(v) for k, v in split.items()}


def remove_invalid_from_split(
    split: Dict[str, List[int]], invalid: List[Tuple[int, int]]
) -> Dict[str, List[int]]:
    """Drop invalid molecule ids from every part (wrapper.py:509-531)."""
    split = {k: list(v) for k, v in split.items()}
    for mol_id, label in invalid:
        if label == 1:
            print("====warning: a positive label is removed====")
        for part in split.values():
            if mol_id in part:
                part.remove(mol_id)
    return split


# ---------------------------------------------------------------------------
# Ingest + cache
# ---------------------------------------------------------------------------
def _cache_path(
    cache_dir: str, dataset: str, backend: str, gnn_type: str = "kgnn"
) -> str:
    # One cache per (gnn_type, AID, D, backend) — the reference's processed
    # file naming (wrapper.py:391-392). kgnn/schnet/dimenet_pp/spherenet all
    # share the MolGraph featurization (3D models read only z+pos from it).
    # ChIRoNet's is an .npz, where the JAX package's is a pickled .npy.
    kind = "chironet" if gnn_type == "chironet" else "kgnn"
    return os.path.join(cache_dir, f"{kind}-{dataset}-3D-{backend}.npz")


# ChiroGraph arrays stored flat: (name, axis along which molecules are
# concatenated, column of ChiroGraph.counts that sizes them).
_CHIRO_ARRAYS = (
    ("x", 0, 0), ("edge_index", 1, 1), ("edge_attr", 0, 1),
    ("distances", 0, 2), ("distance_index", 0, 2), ("angles", 0, 3),
    ("angle_index", 0, 3), ("dihedrals", 0, 4), ("dihedral_index", 0, 4),
    ("ls_map", 0, 4), ("alpha_index", 1, 5),
)


def save_chiro_cache(path: str, graphs, invalid) -> None:
    """ChiroGraphs and the invalid records as an ``.npz`` of flat arrays
    with per-molecule counts (no pickled objects)."""
    from molkgnn_torch.chem.chiro_features import (
        CHIRO_EDGE_DIM,
        CHIRO_NODE_DIM,
    )

    empty = {"x": (0, CHIRO_NODE_DIM), "edge_index": (2, 0),
             "edge_attr": (0, CHIRO_EDGE_DIM), "distance_index": (0, 2),
             "angle_index": (0, 3), "dihedral_index": (0, 4),
             "alpha_index": (2, 0)}
    arrays = {
        name: (np.concatenate([getattr(g, name) for g in graphs], axis=ax)
               if graphs else np.zeros(empty.get(name, (0,))))
        for name, ax, _ in _CHIRO_ARRAYS
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        counts=np.asarray([g.counts() for g in graphs],
                          np.int64).reshape(-1, 6),
        y=np.asarray([g.y for g in graphs], np.float64),
        idx=np.asarray([g.idx for g in graphs], np.int64),
        smiles=np.asarray([g.smiles for g in graphs], dtype=str),
        invalid=np.asarray(invalid, np.int64).reshape(-1, 2),
        **arrays,
    )


def load_chiro_cache(path: str):
    """(ChiroGraphs, invalid records) of ``save_chiro_cache``; the graphs
    hold views into the loaded arrays."""
    from molkgnn_torch.graphs.chiro import ChiroGraph

    with np.load(path, allow_pickle=False) as zf:
        z = {k: zf[k] for k in zf.files}
    counts = z["counts"]
    offs = np.concatenate([np.zeros((1, 6), np.int64),
                           np.cumsum(counts, axis=0)])
    graphs = []
    for i in range(counts.shape[0]):
        fields = {}
        for name, ax, col in _CHIRO_ARRAYS:
            sl = slice(offs[i, col], offs[i + 1, col])
            fields[name] = z[name][:, sl] if ax else z[name][sl]
        graphs.append(ChiroGraph(**fields, y=float(z["y"][i]),
                                 idx=int(z["idx"][i]),
                                 smiles=str(z["smiles"][i])))
    return graphs, [tuple(int(v) for v in row) for row in z["invalid"]]


def _graph_arrays(graphs: List[MolGraph]) -> Dict[str, np.ndarray]:
    return dict(
        x=np.concatenate([g.x for g in graphs]),
        p=np.concatenate([g.p for g in graphs]),
        edge_index=np.concatenate([g.edge_index for g in graphs], axis=1),
        edge_attr=np.concatenate([g.edge_attr for g in graphs]),
        atomic_num=np.concatenate([g.atomic_num for g in graphs]),
        y=np.array([g.y for g in graphs], np.float32),
        idx=np.array([g.idx for g in graphs], np.int64),
        node_counts=np.array([g.num_nodes for g in graphs], np.int64),
        edge_counts=np.array([g.num_edges for g in graphs], np.int64),
        smiles=np.array([g.smiles for g in graphs], dtype=object),
    )


def save_graph_cache(path: str, graphs: List[MolGraph], invalid) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path,
        invalid=np.array(invalid, np.int64).reshape(-1, 2),
        allow_pickle=True,
        **_graph_arrays(graphs),
    )


class StreamingCacheWriter:
    """Shard-streaming processed-cache writer: flushes every ``shard_size``
    featurized molecules to their own compressed npz shard instead of
    holding the full graph list in memory, so the ingest-phase peak RSS is
    bounded by one shard regardless of dataset size. Needed at real-AID
    scale: the largest reference assay is 341k molecules
    (reference utils/data_split.py:68-79) where the single-file path
    (build list -> concatenate -> compress) peaks at several GB.

    Layout next to the single-file cache path ``P``:
    ``P.manifest.json`` (shard count, totals, invalid records) +
    ``P.shard{j:05d}.npz`` (the ``_graph_arrays`` members). Readable with
    ``load_graph_cache_sharded``.
    """

    def __init__(self, cpath: str, shard_size: int = 20000):
        if shard_size <= 0:
            raise ValueError("shard_size must be positive")
        self.cpath = cpath
        self.shard_size = shard_size
        self._buf: List[MolGraph] = []
        self.num_shards = 0
        self.num_graphs = 0
        os.makedirs(os.path.dirname(cpath) or ".", exist_ok=True)

    def shard_path(self, j: int) -> str:
        return f"{self.cpath}.shard{j:05d}.npz"

    def add(self, g: MolGraph) -> None:
        self._buf.append(g)
        if len(self._buf) >= self.shard_size:
            self._flush()

    def _flush(self) -> None:
        if not self._buf:
            return
        np.savez_compressed(
            self.shard_path(self.num_shards),
            allow_pickle=True,
            **_graph_arrays(self._buf),
        )
        self.num_shards += 1
        self.num_graphs += len(self._buf)
        self._buf = []

    def close(self, invalid: List[Tuple[int, int]]) -> None:
        self._flush()
        manifest = {
            "num_shards": self.num_shards,
            "num_graphs": self.num_graphs,
            "shard_size": self.shard_size,
            "invalid": [list(map(int, t)) for t in invalid],
        }
        with open(self.cpath + ".manifest.json", "w") as f:
            json.dump(manifest, f)


def _graphs_from_arrays(z: Dict[str, np.ndarray]) -> List[MolGraph]:
    """MolGraph views over in-memory cache arrays (no copies)."""
    node_off = np.concatenate([[0], np.cumsum(z["node_counts"])])
    edge_off = np.concatenate([[0], np.cumsum(z["edge_counts"])])
    graphs = []
    for i in range(len(z["node_counts"])):
        ns, ne = node_off[i], node_off[i + 1]
        es, ee = edge_off[i], edge_off[i + 1]
        graphs.append(
            MolGraph(
                x=z["x"][ns:ne],
                p=z["p"][ns:ne],
                edge_index=z["edge_index"][:, es:ee],
                edge_attr=z["edge_attr"][es:ee],
                y=float(z["y"][i]),
                atomic_num=z["atomic_num"][ns:ne],
                smiles=str(z["smiles"][i]),
                idx=int(z["idx"][i]),
            )
        )
    return graphs


def load_graph_cache(path: str) -> Tuple[List[MolGraph], List[Tuple[int, int]]]:
    # Materialize every array ONCE before the loop: indexing an NpzFile
    # re-decompresses the whole member on EVERY access, which turns the
    # per-graph loop quadratic (measured: a 62k-mol cache took >10 min to
    # "warm"-load vs ~60 s to build cold; with this hoist it loads in
    # seconds).
    with np.load(path, allow_pickle=True) as zf:
        z = {k: zf[k] for k in zf.files}
    graphs = _graphs_from_arrays(z)
    invalid = [tuple(row) for row in z["invalid"]]
    return graphs, invalid


def load_graph_cache_sharded(
    cpath: str,
) -> Tuple[List[MolGraph], List[Tuple[int, int]]]:
    """Load a ``StreamingCacheWriter`` cache shard by shard. Only one
    shard is decompressed at a time; the returned MolGraphs hold views
    into their shard's arrays, so total memory is the raw data size
    (same as the single-file loader) without its whole-file
    decompression spike."""
    with open(cpath + ".manifest.json") as f:
        manifest = json.load(f)
    graphs: List[MolGraph] = []
    for j in range(manifest["num_shards"]):
        with np.load(
            f"{cpath}.shard{j:05d}.npz", allow_pickle=True
        ) as zf:
            z = {k: zf[k] for k in zf.files}
        graphs.extend(_graphs_from_arrays(z))
    if len(graphs) != manifest["num_graphs"]:
        raise ValueError(
            f"sharded cache {cpath}: manifest says "
            f"{manifest['num_graphs']} graphs, shards hold {len(graphs)}"
        )
    invalid = [tuple(t) for t in manifest["invalid"]]
    return graphs, invalid


def ingest_qsar_sdf(
    root: str,
    dataset: str,
    backend: str = "native",
    progress: bool = True,
    gnn_type: str = "kgnn",
    writer: Optional[StreamingCacheWriter] = None,
) -> Tuple[List[MolGraph], List[Tuple[int, int]]]:
    """Parse + featurize the actives/inactives SDF pair. Returns (graphs,
    invalid (counter, label) pairs); graph ``idx`` is the global counter so
    split indices line up (wrapper.py:414-427).

    With ``writer``, each graph is flushed to the sharded cache instead of
    accumulated (the returned graph list is empty) — SDF -> features ->
    shard streams with memory bounded by one shard."""
    graphs: List[MolGraph] = []
    invalid: List[Tuple[int, int]] = []
    counter = -1
    for file_name, label in (
        (f"{dataset}_actives_new.sdf", 1),
        (f"{dataset}_inactives_new.sdf", 0),
    ):
        path = os.path.join(root, "raw", file_name)
        if backend == "rdkit":
            from rdkit import Chem

            supplier = Chem.SDMolSupplier(path)
            records = ((m, {}) for m in supplier)
        else:
            records = parse_sdf(path)
        for mol, _data in records:
            counter += 1
            if mol is None:
                g = None
            elif gnn_type == "chironet":
                from molkgnn_torch.graphs.chiro import mol_to_chiro_graph

                g = mol_to_chiro_graph(mol, y=float(label), idx=counter)
            else:
                g = mol_to_graph(
                    mol, y=float(label), idx=counter, backend=backend
                )
            if g is None:
                invalid.append((counter, label))
                continue
            if writer is not None:
                writer.add(g)
            else:
                graphs.append(g)
        if progress:
            print(f"ingested {file_name}: {counter + 1} records so far")
    return graphs, invalid


# Datasets with more records than this stream to a sharded cache by
# default (shard_size=None below): the single-file build path's peak RSS
# scales with the dataset (list + concatenate + compress) while the
# streaming path's is bounded by one shard.
STREAM_RECORD_THRESHOLD = 100_000
DEFAULT_SHARD_SIZE = 20_000


def load_qsar_dataset(
    root: str,
    dataset: str = "1798",
    split_file: Optional[str] = None,
    seed: int = 2,
    shrink: bool = True,
    cache_dir: Optional[str] = None,
    backend: str = "native",
    gnn_type: str = "kgnn",
    shard_size: Optional[int] = None,
) -> Dataset:
    """Full pipeline: (cached) ingest -> split -> Dataset.

    ``split_file`` may point at a shipped reference ``.pt`` artifact;
    otherwise the split is regenerated bit-identically from the known
    active/inactive counts (utils/data_split.py defaults: seed 2, shrink).

    ``shard_size``: None (default) = stream to a sharded cache when the
    dataset exceeds STREAM_RECORD_THRESHOLD records; 0 = always the
    single-file cache; >0 = always stream with that shard size. (The
    MolGraph cache only; ChIRoNet's is always one file, as in the JAX
    package.)
    """
    if dataset not in DATASET_INFO:
        raise ValueError(f"Invalid dataset name {dataset}")
    cache_dir = cache_dir or os.path.join(root, "processed")
    cpath = _cache_path(cache_dir, dataset, backend, gnn_type)
    info = DATASET_INFO[dataset]
    if shard_size is None:
        n_records = info["num_active"] + info["num_inactive"]
        shard_size = (
            DEFAULT_SHARD_SIZE if n_records > STREAM_RECORD_THRESHOLD else 0
        )
    if gnn_type == "chironet":
        if os.path.exists(cpath):
            graphs, invalid = load_chiro_cache(cpath)
        else:
            graphs, invalid = ingest_qsar_sdf(root, dataset, backend=backend,
                                              gnn_type=gnn_type)
            save_chiro_cache(cpath, graphs, invalid)
    elif os.path.exists(cpath):
        graphs, invalid = load_graph_cache(cpath)
    elif os.path.exists(cpath + ".manifest.json"):
        graphs, invalid = load_graph_cache_sharded(cpath)
    elif shard_size:
        writer = StreamingCacheWriter(cpath, shard_size=shard_size)
        _, invalid = ingest_qsar_sdf(
            root, dataset, backend=backend, gnn_type=gnn_type, writer=writer
        )
        writer.close(invalid)
        graphs, invalid = load_graph_cache_sharded(cpath)
    else:
        graphs, invalid = ingest_qsar_sdf(
            root, dataset, backend=backend, gnn_type=gnn_type
        )
        save_graph_cache(cpath, graphs, invalid)

    if split_file:
        split = load_reference_split(split_file)
    else:
        info = DATASET_INFO[dataset]
        split = make_split(
            info["num_active"], info["num_inactive"], seed, shrink=shrink
        )
    split = remove_invalid_from_split(split, invalid)

    # Split indices refer to the global record counter; map to positions in
    # the (invalid-free) graph list.
    idx_to_pos = {g.idx: pos for pos, g in enumerate(graphs)}
    split_pos = {
        part: np.array(
            [idx_to_pos[i] for i in ids if i in idx_to_pos], np.int64
        )
        for part, ids in split.items()
    }
    return Dataset(
        name=dataset,
        graphs=graphs,
        split=split_pos,
        metrics=list(QSAR_METRICS),
        loss_name="bce_with_logits",
    )
