"""Model source resolution (a copy of the JAX package's model_resolver.py;
reference lib/llm/src/local_model.rs:39 LocalModelBuilder:
path-or-HF-hub-id -> local model directory).

Resolution order for a ``--model-path`` value:
  1. an existing local directory — used as-is;
  2. a GGUF file — returned with kind="gguf" (metadata/tokenizer via
     dynamo_tpu_torch.gguf);
  3. an HF hub id (org/name) already present in the local HF cache
     (HF_HOME / HF_HUB_CACHE snapshot layout) — the newest snapshot dir;
  4. otherwise: a clear error. Serving hosts run with zero egress, so
     unlike the reference we never download — the cache must be
     pre-populated (e.g. by `huggingface-cli download` on a bastion).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ResolvedModel:
    path: str
    kind: str  # "dir" | "gguf"


# Aliasing fix: two specs naming the SAME on-disk model (a symlinked
# variant directory, a trailing-slash or relative spelling, a hub id
# whose snapshot another spec already resolved) used to come back as
# DIFFERENT ResolvedModel paths — and everything downstream that keys on
# the path (weight loads, model cards, engine registries) duplicated the
# work, loading the same checkpoint once per alias. Resolutions are now
# canonicalised by realpath: the first resolution of an on-disk target
# wins, and every alias returns that same shared object.
_CANONICAL: dict[tuple[str, str], ResolvedModel] = {}


def resolver_cache_clear() -> None:
    """Drop canonical resolutions (tests re-point HF cache env vars)."""
    _CANONICAL.clear()


def _canonical(rm: ResolvedModel) -> ResolvedModel:
    key = (os.path.realpath(rm.path), rm.kind)
    return _CANONICAL.setdefault(key, rm)


def _hub_cache_dirs() -> list[str]:
    roots = []
    if os.environ.get("HF_HUB_CACHE"):
        roots.append(os.environ["HF_HUB_CACHE"])
    hf_home = os.environ.get(
        "HF_HOME", os.path.join(os.path.expanduser("~"), ".cache",
                                "huggingface")
    )
    roots.append(os.path.join(hf_home, "hub"))
    return roots


def _cached_snapshot(repo_id: str) -> Optional[str]:
    """Newest locally-cached snapshot dir for an HF repo id."""
    safe = "models--" + repo_id.replace("/", "--")
    for root in _hub_cache_dirs():
        snap_root = os.path.join(root, safe, "snapshots")
        if not os.path.isdir(snap_root):
            continue
        snaps = [
            os.path.join(snap_root, s) for s in os.listdir(snap_root)
            if os.path.isdir(os.path.join(snap_root, s))
        ]
        if snaps:
            return max(snaps, key=os.path.getmtime)
    return None


def resolve_model(spec: str) -> ResolvedModel:
    """Resolve a model spec to a local path (never downloads)."""
    if os.path.isdir(spec):
        return _canonical(ResolvedModel(path=spec, kind="dir"))
    if os.path.isfile(spec) and spec.endswith(".gguf"):
        return _canonical(ResolvedModel(path=spec, kind="gguf"))
    looks_like_hub_id = (
        spec.count("/") == 1 and not spec.startswith(("/", ".", "~"))
    )
    if looks_like_hub_id and not os.path.exists(spec):
        snap = _cached_snapshot(spec)
        if snap is not None:
            return _canonical(ResolvedModel(path=snap, kind="dir"))
        raise FileNotFoundError(
            f"model {spec!r} is not a local path and is not in the HF "
            f"cache ({', '.join(_hub_cache_dirs())}). Serving hosts have "
            "no egress: pre-populate the cache (huggingface-cli download "
            f"{spec}) or pass a local directory."
        )
    raise FileNotFoundError(
        f"model path {spec!r} does not exist (expected a local HF model "
        "directory, a .gguf file, or a cached hub id like org/name)"
    )
