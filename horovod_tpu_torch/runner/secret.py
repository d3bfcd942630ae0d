"""Shared-secret message authentication for launcher-side services.

A copy of ``horovod_tpu/runner/secret.py``. Parity:
``horovod/runner/common/util/secret.py`` — the reference HMAC-signs
every driver↔task message with a per-job secret so a port scanner on the
cluster network cannot inject control messages. Same contract here:

- the launcher generates a per-job secret (:func:`make_secret_key`) and
  ships it to workers via ``HOROVOD_SECRET_KEY`` in the env block;
- services verify an HMAC-SHA256 tag over each message body;
- comparison is constant-time (``hmac.compare_digest``).
"""

from __future__ import annotations

import hmac
import os
import secrets as _secrets

ENV_KEY = "HOROVOD_SECRET_KEY"
DIGESTMOD = "sha256"


def make_secret_key() -> str:
    return _secrets.token_hex(32)


def current_key() -> bytes | None:
    """The job secret from env, or None (unauthenticated dev mode)."""
    val = os.environ.get(ENV_KEY, "")
    return val.encode() if val else None


def sign(body: bytes, key: bytes | None = None) -> str:
    key = key if key is not None else current_key()
    if key is None:
        return ""
    return hmac.new(key, body, DIGESTMOD).hexdigest()


def verify(body: bytes, tag: str, key: bytes | None = None) -> bool:
    key = key if key is not None else current_key()
    if key is None:
        return True  # no secret configured: open mode (dev/back-compat)
    if not tag:
        return False
    return hmac.compare_digest(hmac.new(key, body, DIGESTMOD).hexdigest(),
                               tag)
