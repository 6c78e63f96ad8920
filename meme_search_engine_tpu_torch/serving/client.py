"""Clients for the embedding service.

``RemoteEmbedder`` speaks the msgpack HTTP protocol (reference client:
common.rs:86-96 query_clip_server, :68-83 get_backend_config retry
loop). ``InProcessEmbedder`` wraps the port's EmbeddingEngine directly
for single-process deployments (no HTTP hop; the card is in-process).
Both expose: embed_texts(list[str]), embed_image_bytes(list[bytes]),
and ``config`` (InferenceServerConfig).

A copy of ``meme_search_engine_tpu/serving/client.py``, which the port
keeps rather than imports. ``msgpack`` and ``aiohttp`` are imported by
``RemoteEmbedder`` where it uses them, so the module imports on a host
without them.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..utils.fp16 import decode_fp16_buffer
from .preprocess import decode_and_resize, decode_and_resize_naflex
from .wire import InferenceServerConfig

__all__ = ["RemoteEmbedder", "InProcessEmbedder"]


class RemoteEmbedder:
    def __init__(self, base_url: str, session=None):
        self.base_url = base_url.rstrip("/")
        self._session = session
        self.config: InferenceServerConfig = None  # set by connect()

    async def _ensure_session(self):
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession()
        return self._session

    async def connect(self, retry_interval: float = 1.0):
        """Fetch /config with the reference's infinite retry loop
        (common.rs:73-83)."""
        import msgpack

        session = await self._ensure_session()
        while True:
            try:
                async with session.get(self.base_url + "/config") as resp:
                    data = msgpack.unpackb(await resp.read(), raw=False)
                self.config = InferenceServerConfig.from_msgpack_dict(data)
                return self.config
            except Exception as e:  # noqa: BLE001
                print(f"Backend failed (fetch): {e}")
                import asyncio

                await asyncio.sleep(retry_interval)

    async def _post(self, payload: dict) -> List[np.ndarray]:
        import msgpack

        session = await self._ensure_session()
        async with session.post(
            self.base_url + "/",
            data=msgpack.packb(payload),
            headers={"Content-Type": "application/msgpack"},
        ) as resp:
            body = msgpack.unpackb(await resp.read(), raw=False)
            if resp.status != 200:
                raise RuntimeError(f"embedding backend error: {body}")
        return [decode_fp16_buffer(b) for b in body]

    async def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack(await self._post({"text": list(texts)}))

    async def embed_image_bytes(self, images: Sequence[bytes]) -> np.ndarray:
        return np.stack(
            await self._post({"images": [bytes(i) for i in images]})
        )

    async def close(self):
        if self._session is not None:
            await self._session.close()


class InProcessEmbedder:
    """Direct engine calls; fp16 round-trip retained for wire parity. A
    SigLIP 2 NaFlex engine takes each picture at its own grid
    (``preprocess.decode_and_resize_naflex``, ``embed_image_list``), as
    the clip server does."""

    def __init__(self, engine):
        self.engine = engine
        cfg = engine.cfg
        naflex = bool(cfg.max_num_patches)
        self.config = InferenceServerConfig(
            batch=engine.max_batch,
            image_size=None if naflex else (cfg.image_size, cfg.image_size),
            embedding_size=cfg.d_emb,
            model="siglip2-so400m/16-naflex" if naflex else "siglip-so400m/14@384",
            patch_size=cfg.patch_size if naflex else 0,
            max_num_patches=cfg.max_num_patches,
        )

    async def connect(self):
        return self.config

    async def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        return self.engine.embed_texts(texts).astype(np.float16).astype(np.float32)

    async def embed_image_bytes(self, images: Sequence[bytes]) -> np.ndarray:
        c = self.config
        if c.max_num_patches:
            pictures = [decode_and_resize_naflex(b, c.patch_size, c.max_num_patches) for b in images]
            out = self.engine.embed_image_list(pictures)
        else:
            out = self.engine.embed_image_arrays(
                np.stack([decode_and_resize(b, c.image_size) for b in images]))
        return out.astype(np.float16).astype(np.float32)

    async def close(self):
        pass
