"""Predict engines: query embedding + answer generation seams.

The port's copy of ``nucliadb_tpu/search/predict.py``,
kept verbatim: the port imports nothing of the JAX package.

Parity with the reference's Predict API client
(nucliadb/src/nucliadb/search/predict.py:343,513 — /query embeddings,
/chat generation against the external Nuclia Predict service):

- ``HTTPPredictEngine`` speaks the same role over HTTP to any service
  exposing /embed and /generate.
- ``LocalPredictEngine`` runs an in-process encoder callable (e.g. a
  flax/transformers model the deployment loads itself) — the embedded
  deployment's replacement for the external dependency.
- ``HashingEncoder`` is a deterministic, dependency-free fallback (feature
  hashing of token n-grams): functional for tests/dev, not semantically
  meaningful — real deployments plug a model.
"""

from __future__ import annotations

import hashlib
import json
from typing import Callable, Iterator, Optional

import httpx
import numpy as np

from ..index.text_engine.tokenizer import tokenize


class HashingEncoder:
    """Feature-hashing bag-of-ngrams embedding (deterministic, no ML)."""

    def __init__(self, dimension: int = 256):
        self.dimension = dimension

    def __call__(self, text: str) -> np.ndarray:
        v = np.zeros(self.dimension, np.float32)
        tokens = tokenize(text)
        grams = tokens + [" ".join(p) for p in zip(tokens, tokens[1:])]
        for g in grams:
            h = hashlib.blake2b(g.encode(), digest_size=8).digest()
            idx = int.from_bytes(h[:4], "little") % self.dimension
            sign = 1.0 if h[4] & 1 else -1.0
            v[idx] += sign
        n = np.linalg.norm(v)
        return v / n if n else v


class LocalPredictEngine:
    """In-process embeddings (+ optional generation/rerank callables).

    Covers the reference Predict client's full method surface
    (search/predict.py: /query embeddings + rephrase + entity detection,
    /chat generation, /rerank, /summarize) with local callables; every
    hook has a deterministic dependency-free default so embedded
    deployments work without any external model service.
    """

    def __init__(
        self,
        encoder: Optional[Callable[[str], np.ndarray]] = None,
        generator: Optional[Callable[[str, list[str]], str]] = None,
        reranker: Optional[Callable[[str, list[str]], list[float]]] = None,
        stream_generator: "Optional[Callable[[str, list[str]], Iterator[str]]]" = None,
    ):
        self.encoder = encoder or HashingEncoder()
        self.generator = generator
        self.reranker = reranker
        self.stream_generator = stream_generator

    def embed(self, kbid: str, vectorset: str, text: str) -> Optional[np.ndarray]:
        return np.asarray(self.encoder(text), np.float32)

    def generate(self, kbid: str, prompt: str, context: list[str]) -> str:
        if self.generator is None and self.stream_generator is not None:
            return "".join(self.stream_generator(prompt, context))
        if self.generator is None:
            joined = "\n\n".join(context[:3])
            return f"[no generative model configured]\n{joined}"
        return self.generator(prompt, context)

    def generate_stream(
        self, kbid: str, prompt: str, context: list[str]
    ) -> "Iterator[str]":
        """Answer chunks AS the model produces them (parity: the reference
        streams Predict /chat tokens through /ask's ndjson items,
        chat/ask.py:210-370). A deployment plugs a token-streaming model via
        ``stream_generator``; without one the blocking answer is one chunk."""
        if self.stream_generator is not None:
            yield from self.stream_generator(prompt, context)
            return
        yield self.generate(kbid, prompt, context)

    def rerank(self, kbid: str, query: str, passages: list[str]) -> list[float]:
        """Model scores per passage (higher = better). Default: cosine of
        the hashing embeddings — deterministic, test-grade."""
        if self.reranker is not None:
            return list(self.reranker(query, passages))
        q = self.embed(kbid, "", query)
        out = []
        for p in passages:
            v = self.embed(kbid, "", p)
            out.append(float(np.dot(q, v)))
        return out

    def rephrase(self, kbid: str, query: str, chat_history: list[dict]) -> str:
        """Standalone-question rewrite given chat history (parity:
        predict.py rephrase_query). Default folds trailing user turns in."""
        if self.generator is not None:
            prompt = (
                "Rewrite the last user question as a standalone question.\n"
                + "\n".join(f"{m.get('author', 'user')}: {m.get('text', '')}" for m in chat_history)
                + f"\nuser: {query}"
            )
            return self.generator(prompt, [])
        prev = [m.get("text", "") for m in chat_history if m.get("author", "user") == "user"]
        return " ".join(prev[-2:] + [query]).strip() if prev else query

    def detect_entities(self, kbid: str, text: str) -> list[dict]:
        """Capitalized-token entity spans (parity: /query entity detection;
        real deployments plug an NER model via the generator seam)."""
        out = []
        for m in __import__("re").finditer(r"\b([A-Z][a-zA-Z0-9_-]+(?:\s+[A-Z][a-zA-Z0-9_-]+)*)", text):
            if m.start() == 0 and " " not in m.group(0) and len(out) == 0 and text[:1].isupper():
                continue  # sentence-initial single word: usually not an entity
            out.append({"text": m.group(0), "family": "GENERIC", "start": m.start(), "end": m.end()})
        return out

    def summarize(self, kbid: str, texts: list[str]) -> str:
        if self.generator is not None:
            return self.generator("Summarize the following documents.", texts)
        return " ".join(t.split(".")[0].strip() + "." for t in texts if t.strip())


class HTTPPredictEngine:
    """Remote predict service (the reference's Predict API role)."""

    def __init__(self, base_url: str, timeout: float = 30.0):
        self.client = httpx.Client(base_url=base_url, timeout=timeout)

    def embed(self, kbid: str, vectorset: str, text: str) -> Optional[np.ndarray]:
        resp = self.client.post(
            "/embed", json={"kbid": kbid, "vectorset": vectorset, "text": text}
        )
        resp.raise_for_status()
        return np.asarray(resp.json()["vector"], np.float32)

    def generate(self, kbid: str, prompt: str, context: list[str]) -> str:
        resp = self.client.post(
            "/generate", json={"kbid": kbid, "prompt": prompt, "context": context}
        )
        resp.raise_for_status()
        return resp.json()["answer"]

    def generate_stream(
        self, kbid: str, prompt: str, context: list[str]
    ) -> Iterator[str]:
        """Token stream from the predict service: POST /generate with
        ``stream: true`` and relay ndjson ``{"chunk": ...}`` lines as they
        arrive (parity: the reference's Predict /chat streaming,
        search/predict.py get_answer_generator). A service answering with a
        plain JSON body (no streaming support) degrades to one chunk."""
        with self.client.stream(
            "POST",
            "/generate",
            json={"kbid": kbid, "prompt": prompt, "context": context,
                  "stream": True},
        ) as resp:
            resp.raise_for_status()
            ctype = resp.headers.get("content-type", "")
            if "ndjson" not in ctype and "json-lines" not in ctype:
                body = b"".join(resp.iter_bytes())
                yield json.loads(body.decode("utf-8"))["answer"]
                return
            for line in resp.iter_lines():
                if not line.strip():
                    continue
                item = json.loads(line)
                chunk = item.get("chunk", item.get("answer", ""))
                if chunk:
                    yield chunk

    def rerank(self, kbid: str, query: str, passages: list[str]) -> list[float]:
        resp = self.client.post(
            "/rerank", json={"kbid": kbid, "query": query, "passages": passages}
        )
        resp.raise_for_status()
        return list(resp.json()["scores"])

    def rephrase(self, kbid: str, query: str, chat_history: list[dict]) -> str:
        resp = self.client.post(
            "/rephrase", json={"kbid": kbid, "query": query, "chat_history": chat_history}
        )
        resp.raise_for_status()
        return resp.json()["rephrased"]

    def detect_entities(self, kbid: str, text: str) -> list[dict]:
        resp = self.client.post("/entities", json={"kbid": kbid, "text": text})
        resp.raise_for_status()
        return list(resp.json()["entities"])

    def summarize(self, kbid: str, texts: list[str]) -> str:
        resp = self.client.post("/summarize", json={"kbid": kbid, "texts": texts})
        resp.raise_for_status()
        return resp.json()["summary"]
