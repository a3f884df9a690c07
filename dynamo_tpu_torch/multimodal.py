"""Multimodal E/P/D serving graph (PyTorch port of the JAX package's
multimodal.py; reference examples/multimodal: encode worker + embedding
transfer + prefill consumption, components/encode_worker.py:148,
disagg_router.py:48-66).

Three stages:

  1. ``EncodeWorker`` — a runtime component serving an ``encode``
     endpoint: images in, language-model embedding rows out (the vision
     tower, models/vision.py, runs as its own worker so encoder and LLM
     scale independently, the reference's E/P/D split).
  2. Over the runtime the rows travel as array-frame tickets
     (kv_transfer.py ``ArrayFrameServer``): the RPC reply names a ticket,
     and the peer collects the raw f32 rows over the frame2 side channel.
  3. ``MultimodalEngine`` — an engine wrapper in front of a decode
     engine: resolves a request's images through a local encoder or the
     encode endpoint, attaches the embedding rows and the images' content
     digest to a copy of the request (``PreprocessedRequest.multimodal``),
     and delegates. TorchEngine injects the rows in place of the
     ``<image>`` placeholder tokens' embeddings during prefill
     (``llama.prefill`` ``embeds``) and salts the request's block hashes
     with the digest, so prefix caching never serves one image's KV for
     another's.

The caller's prompt must already hold a run of placeholder tokens per
image; ``images[i]["pos"]`` marks where each run starts (the HTTP
preprocessor's image lowering produces this shape). Rows are f32 CPU
tensors ``[num_patches, out_hidden]``.
"""
from __future__ import annotations

import asyncio
import base64
import dataclasses
import hashlib
import logging
from typing import Any, AsyncIterator, Optional

import numpy as np
import torch

from dynamo_tpu_torch.protocols.common import LLMEngineOutput, PreprocessedRequest

log = logging.getLogger(__name__)


def encode_image_payload(image: np.ndarray) -> dict[str, Any]:
    """Pack an [H, W, 3] float32 image for the encode endpoint."""
    arr = np.ascontiguousarray(image, np.float32)
    return {
        "data": base64.b64encode(arr.tobytes()).decode(),
        "shape": list(arr.shape),
    }


def decode_image_payload(payload: dict[str, Any]) -> np.ndarray:
    raw = base64.b64decode(payload["data"])
    return np.frombuffer(raw, np.float32).reshape(payload["shape"]).copy()


def images_digest(images: list[dict[str, Any]]) -> str:
    """Content digest over every image's bytes (prefix-cache salt)."""
    h = hashlib.sha256()
    for im in images:
        h.update(str(im.get("shape")).encode())
        h.update(base64.b64decode(im["data"]))
    return h.hexdigest()[:16]


class EncodeWorker:
    """Vision-encoder worker: serves ``encode`` on the runtime (reference
    encode_worker.py:148). The tower runs where its params are (without
    them, it is drawn from seed 0 on the card). Each image is encoded on
    a worker thread (on the card, on a CUDA stream of its own,
    synchronized before its rows come back to the host)."""

    def __init__(
        self,
        rt: Any,
        vision_cfg: Any = None,
        params: Any = None,
        namespace: str = "dynamo",
        component: str = "encoder",
        worker_id: str = "encoder-0",
    ):
        from dynamo_tpu_torch.models.vision import (
            VisionConfig,
            init_vision_params,
        )

        self.rt = rt
        self.cfg = vision_cfg or VisionConfig.tiny()
        self.params = params if params is not None else init_vision_params(
            self.cfg, 0)
        self.device = self.params["patch_embed"].device
        self.namespace = namespace
        self.component = component
        self.worker_id = worker_id
        self.images_encoded = 0
        self._served = None
        self._frames = None   # ArrayFrameServer (RPC transport only)
        self._stream: Optional[torch.cuda.Stream] = None

    def _encode_one(self, image: np.ndarray) -> torch.Tensor:
        from dynamo_tpu_torch.models.vision import encode_image

        if self.device.type != "cuda":
            return encode_image(self.cfg, self.params, image).float()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            rows = encode_image(self.cfg, self.params, image).float().cpu()
        self._stream.synchronize()
        return rows

    async def encode_arrays(self, images: list[dict]) -> list[torch.Tensor]:
        """Encode to f32 CPU tensors [num_patches, out_hidden] (the
        in-process path — no transport)."""
        out = []
        for im in images:
            arr = decode_image_payload(im)
            out.append(await asyncio.to_thread(self._encode_one, arr))
            self.images_encoded += 1
        return out

    async def _handle(self, payload: dict) -> AsyncIterator[dict]:
        """RPC path: embeddings go as array-frame TICKETS, not JSON float
        lists — the peer collects the raw tensors over the frame2 side
        channel (reference moves them via NIXL, encode_worker.py:148).
        A LLaVA-scale image is ~9 MB of f32; JSON would 10x that."""
        embs = await self.encode_arrays(payload.get("images", []))
        out = []
        for emb in embs:
            out.append({
                "ticket": self._frames.park(emb),
                "host": self._frames.host, "port": self._frames.port,
                "shape": list(emb.shape),
            })
        yield {"embeddings": out}

    async def start(self) -> "EncodeWorker":
        from dynamo_tpu_torch.kv_transfer import ArrayFrameServer

        self._frames = ArrayFrameServer()
        await self._frames.start()
        ep = self.rt.namespace(self.namespace).component(
            self.component).endpoint("encode")
        self._served = await ep.serve(self._handle, worker_id=self.worker_id)
        return self

    async def stop(self) -> None:
        if self._served is not None:
            await self._served.shutdown()
            self._served = None
        if self._frames is not None:
            await self._frames.stop()
            self._frames = None


class MultimodalEngine:
    """Engine wrapper: encode stage -> embedding attach -> delegate (the
    reference's 3-stage disaggregation, orchestrated)."""

    def __init__(
        self,
        inner: Any,
        rt: Any = None,
        namespace: str = "dynamo",
        component: str = "encoder",
        local_encoder: Optional[Any] = None,  # EncodeWorker for in-process
    ):
        self.inner = inner
        self.rt = rt
        self.namespace = namespace
        self.component = component
        self.local_encoder = local_encoder
        self.images_resolved = 0
        self._client = None

    async def _encode(self, images: list[dict]) -> list[torch.Tensor]:
        if self.local_encoder is not None:
            return await self.local_encoder.encode_arrays(images)
        if self._client is None:
            self._client = await self.rt.namespace(self.namespace).component(
                self.component).endpoint("encode").client()
        from dynamo_tpu_torch.kv_transfer import take_remote_array

        async for item in self._client.generate({"images": images}):
            out: list[torch.Tensor] = []
            for ent in item["embeddings"]:
                if isinstance(ent, dict) and "ticket" in ent:
                    # array-frame transport: collect the raw tensor
                    out.append(await take_remote_array(
                        ent["host"], ent["port"], ent["ticket"]))
                else:  # legacy float-list responses stay readable
                    out.append(torch.as_tensor(ent, dtype=torch.float32))
            return out
        raise RuntimeError("encode endpoint returned no response")

    async def generate(
        self, request: PreprocessedRequest
    ) -> AsyncIterator[LLMEngineOutput]:
        mm = request.multimodal or {}
        images = mm.get("images")
        if images:
            embs = await self._encode(images)
            entries = [{"pos": int(im["pos"]), "data": rows}
                       for im, rows in zip(images, embs)]
            self.images_resolved += len(entries)
            # resolved COPY: the caller's request keeps its raw images
            # (idempotent under frontend retry/failover re-dispatch)
            request = dataclasses.replace(request, multimodal={
                "embeddings": entries,
                "digest": images_digest(images),
            })
        async for out in self.inner.generate(request):
            yield out

    async def stop(self) -> None:
        stop = getattr(self.inner, "stop", None)
        if stop is not None:
            await stop()
