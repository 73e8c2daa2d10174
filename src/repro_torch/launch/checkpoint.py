"""Step checkpoints with an atomic commit and resume, and HQP artifacts on
disk, in the JAX package's layout (its ``launch/checkpoint.py``).

Layout of a checkpoint:
  <dir>/step_000123/
      meta.json            # step, time, array count, the caller's extras
      arrays.npz           # the tree's leaves, keyed by their path
      .COMMITTED           # written last: a checkpoint without it is torn
                           # (the writer died mid-write) and is ignored

The keys are the JAX package's: "/"-joined paths of its tree, whose
``blocks`` stack the layers along axis 0 under ``blocks/0``; a bf16 leaf is
stored as its uint16 view under ``"__bf16__" + key``. So either package
restores a checkpoint the other wrote, and the same holds for artifacts
(``manifest.json`` with the tree spec, plus ``arrays.npz``). Restore puts
the arrays on the device of the tree it fills (mesh and sharding are not
ported)."""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, tree
from repro_torch.compress.artifact import (HQPArtifact, HQPManifest,
                                           spec_to_tree, tree_to_spec)
from repro_torch.weights import (from_numpy, stack_blocks, to_device,
                                 to_numpy, unstack_blocks)

COMMIT_MARKER = ".COMMITTED"
ARTIFACT_MANIFEST = "manifest.json"
ARTIFACT_ARRAYS = "arrays.npz"
BF16_TAG = "__bf16__"


def path_str(path) -> str:
    """"/"-joined tree path: the array key of both packages' layouts."""
    return "/".join(str(p) for p in path)


def _flatten(node: Any, path: tuple = (), flat: Optional[dict] = None
             ) -> Dict[str, np.ndarray]:
    """Every tensor of a tree in the JAX layout, keyed by its path."""
    flat = {} if flat is None else flat
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, path + (k,), flat)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, path + (i,), flat)
    else:
        key = path_str(path)
        flat[BF16_TAG + key if node.dtype == torch.bfloat16 else key] = \
            to_numpy(node)
    return flat


def _commit(tmp: pathlib.Path, final: pathlib.Path) -> None:
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    (final / COMMIT_MARKER).touch()


def _fresh_tmp(tmp: pathlib.Path) -> pathlib.Path:
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    return tmp


def save(ckpt_dir: str, step: int, state: Any,
         extra_meta: Optional[dict] = None) -> str:
    """Write ``state`` (a tree of tensors: dicts, lists, tuples; e.g.
    ``(params, opt_state)``) as step ``step``. Atomic: written into a tmp
    directory, renamed, then commit-marked."""
    base = pathlib.Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:09d}"
    tmp = _fresh_tmp(base / f".tmp_step_{step:09d}_{os.getpid()}")
    flat = _flatten(stack_blocks(to_device(state, "cpu")))
    np.savez(tmp / "arrays.npz", **flat)
    meta = {"step": step, "time": time.time(), "n_arrays": len(flat),
            **(extra_meta or {})}
    (tmp / "meta.json").write_text(json.dumps(meta))
    _commit(tmp, final)
    return str(final)


def _committed_steps(base: pathlib.Path) -> list:
    if not base.exists():
        return []
    return sorted(int(d.name.split("_")[1]) for d in base.iterdir()
                  if d.name.startswith("step_")
                  and (d / COMMIT_MARKER).exists())


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _committed_steps(pathlib.Path(ckpt_dir))
    return steps[-1] if steps else None


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None
            ) -> Tuple[Any, dict]:
    """(the checkpoint of ``step``, default the latest committed one, in
    the structure, dtypes and devices of ``like``; its meta). Raises
    ``FileNotFoundError`` when there is none or it is torn, ``KeyError``
    when a leaf of ``like`` has no array, ``ValueError`` when an array's
    shape differs from its leaf's."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = pathlib.Path(ckpt_dir) / f"step_{step:09d}"
    if not (d / COMMIT_MARKER).exists():
        raise FileNotFoundError(f"checkpoint {d} is not committed (torn "
                                f"write)")
    meta = json.loads((d / "meta.json").read_text())
    # the JAX layout of ``like``: shapes and dtypes only
    skeleton = stack_blocks(tree.map_(lambda t: t.to("meta"), like))
    with np.load(d / "arrays.npz") as data:
        state = unstack_blocks(_fill(skeleton, (), data, d))
    return tree.map_(lambda t, ref: t.to(ref.device), state, like), meta


def _fill(node: Any, path: tuple, data, where) -> Any:
    """``node``'s structure (the JAX layout, meta tensors) with every leaf
    read from ``data`` by its path, as a CPU tensor of the leaf's dtype."""
    if isinstance(node, dict):
        return {k: _fill(v, path + (k,), data, where)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_fill(v, path + (i,), data, where)
                          for i, v in enumerate(node))
    key = path_str(path)
    bf16 = BF16_TAG + key in data
    arr = data[BF16_TAG + key if bf16 else key]
    if tuple(arr.shape) != tuple(node.shape):
        raise ValueError(f"checkpoint {where}: {key} has shape {arr.shape}, "
                         f"expected {tuple(node.shape)}")
    return from_numpy(arr, bf16=bf16).to(node.dtype)


def prune_old(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the ``keep`` latest committed checkpoints."""
    base = pathlib.Path(ckpt_dir)
    for s in _committed_steps(base)[:-keep]:
        shutil.rmtree(base / f"step_{s:09d}", ignore_errors=True)


# ------------------------------------------------------------------ artifact
def save_artifact(art_dir: str, artifact: HQPArtifact) -> str:
    """Write an ``HQPArtifact`` as the JAX package does (atomic commit):
    ``manifest.json`` holds the manifest and the tree spec, ``arrays.npz``
    the leaves, the layers stacked. An artifact whose layers differ in
    width (a per-layer cut) cannot be stacked: ``ValueError``."""
    base = pathlib.Path(art_dir)
    base.parent.mkdir(parents=True, exist_ok=True)
    stacked = stack_blocks(to_device(artifact.params, "cpu"))
    tmp = _fresh_tmp(base.parent / f".tmp_{base.name}_{os.getpid()}")
    arrays: list = []
    spec = tree_to_spec(stacked, arrays)
    np.savez(tmp / ARTIFACT_ARRAYS,
             **{f"a{i}": a for i, a in enumerate(arrays)})
    (tmp / ARTIFACT_MANIFEST).write_text(json.dumps(
        {"manifest": artifact.manifest.asdict(), "tree": spec,
         "n_arrays": len(arrays), "time": time.time()}))
    _commit(tmp, base)
    return str(base)


def load_artifact(art_dir: str, device=None) -> HQPArtifact:
    """Read an artifact either package wrote into an ``HQPArtifact`` with
    its params on ``device`` (default the card, as ``resolve_device``
    says). An artifact without the commit marker is a torn write and is
    refused."""
    dev = resolve_device(device)
    base = pathlib.Path(art_dir)
    if not base.exists():
        raise FileNotFoundError(f"no artifact at {base}")
    if not (base / COMMIT_MARKER).exists():
        raise FileNotFoundError(f"artifact {base} is not committed "
                                f"(torn write)")
    meta = json.loads((base / ARTIFACT_MANIFEST).read_text())
    with np.load(base / ARTIFACT_ARRAYS) as data:
        arrays = [data[f"a{i}"] for i in range(meta["n_arrays"])]
    params = unstack_blocks(spec_to_tree(meta["tree"], arrays))
    return HQPArtifact(to_device(params, dev),
                       HQPManifest.fromdict(meta["manifest"]))
