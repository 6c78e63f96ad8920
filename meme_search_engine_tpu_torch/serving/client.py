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
from .preprocess import decode_and_resize
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
    """Direct engine calls; fp16 round-trip retained for wire parity."""

    def __init__(self, engine):
        self.engine = engine
        self.config = InferenceServerConfig(
            batch=engine.max_batch,
            image_size=(engine.cfg.image_size, engine.cfg.image_size),
            embedding_size=engine.cfg.d_emb,
            model="siglip-so400m/14@384",
        )

    async def connect(self):
        return self.config

    async def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        return self.engine.embed_texts(texts).astype(np.float16).astype(np.float32)

    async def embed_image_bytes(self, images: Sequence[bytes]) -> np.ndarray:
        size = self.config.image_size
        arrays = np.stack([decode_and_resize(b, size) for b in images])
        out = self.engine.embed_image_arrays(arrays)
        return out.astype(np.float16).astype(np.float32)

    async def close(self):
        pass
