"""Model deployment card: tokenizer/config artifacts via the object store
(a copy of the JAX package's model_card.py).

Parity: reference lib/llm/src/model_card/model.rs — ModelDeploymentCard
(:86) carries ModelInfo/Tokenizer/PromptFormatter artifacts, uploaded to
the NATS object store at registration (:256) and downloaded by frontends
that don't share a filesystem with the worker (:305). Here the artifacts
ride the store's object plane (runtime/client.py ObjectStore) under
bucket ``cards/{namespace}/{model}``.
"""
from __future__ import annotations

import logging
import os
import tempfile
from typing import Optional

from dynamo_tpu_torch.runtime.client import KvClient, ObjectStore

log = logging.getLogger(__name__)

# artifacts a frontend needs to tokenize/format for the model
CARD_FILES = (
    "tokenizer.json",
    "tokenizer_config.json",
    "config.json",
    "special_tokens_map.json",
    "generation_config.json",
    "chat_template.jinja",
    # tenancy plane: the fine-tune variant manifest — which servable
    # names map to which resident adapter rows (frontends registering
    # variants need it; workers without one serve only the base model)
    "adapters.json",
)

# object-plane payloads are base64-encoded (4/3 inflation) into frames
# capped at 64 MiB — stay well under so an oversized artifact can never
# produce a frame that kills the shared control-plane connection
MAX_ARTIFACT_BYTES = 40 * 1024 * 1024


def card_bucket(namespace: str, model: str) -> str:
    return f"cards/{namespace}/{model}"


async def upload_card(
    kv: KvClient, namespace: str, model: str, model_dir: str
) -> Optional[str]:
    """Upload the model's tokenizer/config artifacts; returns the bucket
    ref, or None if the dir holds no artifacts (nothing to share)."""
    store = ObjectStore(kv)
    bucket = card_bucket(namespace, model)
    uploaded: list[str] = []
    for name in CARD_FILES:
        path = os.path.join(model_dir, name)
        if not os.path.exists(path):
            continue
        size = os.path.getsize(path)
        if size > MAX_ARTIFACT_BYTES:
            log.warning("card artifact %s too large (%d B); skipped",
                        name, size)
            continue
        with open(path, "rb") as f:
            await store.put(bucket, name, f.read())
        uploaded.append(name)
    if "tokenizer.json" not in uploaded:
        # a card a frontend can't load a tokenizer from is worse than no
        # card (it would shadow the local-path fallback)
        for name in uploaded:
            await store.delete(bucket, name)
        return None
    log.info("uploaded %d card artifacts for %s/%s", len(uploaded),
             namespace, model)
    return bucket


async def download_card(
    kv: KvClient, bucket: str, dest_dir: Optional[str] = None
) -> Optional[str]:
    """Materialize a card's artifacts into a local dir (tempdir by
    default); returns the dir, or None if the bucket is empty."""
    store = ObjectStore(kv)
    names = await store.list(bucket)
    if not names:
        return None
    dest = dest_dir or tempfile.mkdtemp(prefix="dynamo-card-")
    os.makedirs(dest, exist_ok=True)
    for name in names:
        if name not in CARD_FILES:
            continue  # never write unexpected filenames to disk
        data = await store.get(bucket, name)
        if data is None:
            continue
        with open(os.path.join(dest, name), "wb") as f:
            f.write(data)
    return dest


async def delete_card(kv: KvClient, bucket: str) -> None:
    store = ObjectStore(kv)
    for name in await store.list(bucket):
        await store.delete(bucket, name)
