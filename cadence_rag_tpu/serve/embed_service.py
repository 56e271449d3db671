"""Standalone /embed service: drop-in for the reference's embedding gateway.

The reference's dense lane depends on an external GPU service
(Triton + FastAPI gateway: POST /embed {"texts", "model"} ->
{"embeddings", "model"}; reference: P620_..RUNBOOK.md:489-497). This module
serves the SAME wire contract from this framework's own providers (neural
transformer on the device, or the deterministic hash embedder), so a reference
deployment can point its EMBEDDINGS_BASE_URL here — or two instances of
this framework can embed for each other.

Run:  python -m cadence_rag_tpu.serve.embed_service --port 9090
      [--provider neural|stub]
"""

from __future__ import annotations

import argparse
import asyncio
import json

from ..config import settings
from ..logging_utils import configure_logging, get_logger

logger = get_logger(__name__)


def make_embed_app(provider_kind: str = ""):
    from aiohttp import web

    from ..embed.provider import EmbeddingError, get_provider

    if provider_kind:
        settings.embeddings_provider = provider_kind
    provider = get_provider()
    logger.info("embed_service.start model=%s", provider.model_id)

    async def embed(request: "web.Request") -> "web.Response":
        try:
            body = json.loads(await request.read())
        except json.JSONDecodeError:
            return web.json_response({"detail": "invalid JSON"}, status=400)
        texts = body.get("texts")
        if not isinstance(texts, list) or not texts:
            return web.json_response(
                {"detail": "'texts' must be a non-empty list"}, status=400
            )
        try:
            result = await asyncio.get_event_loop().run_in_executor(
                None, lambda: provider.embed([str(t) for t in texts])
            )
        except EmbeddingError as exc:
            return web.json_response({"detail": str(exc)}, status=500)
        import numpy as np

        return web.json_response(
            {
                "embeddings": np.asarray(result.vectors).tolist(),
                "model": result.model,
            }
        )

    async def health(_request) -> "web.Response":
        return web.json_response({"status": "ok", "model": provider.model_id})

    app = web.Application(client_max_size=64 * 1024 * 1024)
    app.router.add_post("/embed", embed)
    app.router.add_get("/health", health)
    return app


def main() -> None:
    from aiohttp import web

    parser = argparse.ArgumentParser(description="embedding service")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9090)
    parser.add_argument("--provider", default="neural",
                        choices=["neural", "stub"])
    args = parser.parse_args()
    configure_logging(settings.log_level)
    web.run_app(make_embed_app(args.provider), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
