"""Secrets encryption for stored configs and runtime-config transport.

Reference parity: core/_private/crypto.py:6 (AESCipher, AES-CBC via
pycryptodomex) and utils.py:449 encrypt_config / :3462 encrypt_config_value.
This build uses AES-256-GCM (authenticated) from `cryptography` instead of
bare CBC — same role, better primitive.
"""

from __future__ import annotations

import base64
import copy
import hashlib
import hmac as _hmac
import os
from typing import Any, Dict

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # gated dep: containers without `cryptography`
    AESGCM = None

_NONCE_LEN = 12
# Backend-tagged framing: AES-GCM values carry the original prefix,
# stdlib-AEAD values a distinct one, so a mixed-install cluster (head
# with `cryptography`, worker without) fails LOUDLY with the real cause
# instead of a bare tag-mismatch.  Stdlib-framed values decrypt on every
# host (the fallback is pure stdlib and always constructible).
_PREFIX = "tik-enc:"
_PREFIX_STDLIB = "tik-encs:"
_TAG_LEN = 16


class _StdlibAEAD:
    """Authenticated encryption from the stdlib, used ONLY when
    `cryptography` is unavailable: HMAC-SHA256 keystream (CTR-style) +
    encrypt-then-MAC tag.  Same interface and framing as AESGCM so the
    rest of the module is oblivious; ciphertexts are NOT interoperable
    between the two backends (a deployment uses one stack throughout)."""

    def __init__(self, key: bytes):
        self._enc_key = hashlib.sha256(key + b"|enc").digest()
        self._mac_key = hashlib.sha256(key + b"|mac").digest()

    def _keystream(self, nonce: bytes, n: int) -> bytes:
        out = b""
        counter = 0
        while len(out) < n:
            out += hashlib.sha256(
                self._enc_key + nonce + counter.to_bytes(8, "big")).digest()
            counter += 1
        return out[:n]

    def encrypt(self, nonce: bytes, data: bytes, _aad) -> bytes:
        ct = bytes(a ^ b for a, b in
                   zip(data, self._keystream(nonce, len(data))))
        tag = _hmac.new(self._mac_key, nonce + ct,
                        hashlib.sha256).digest()[:_TAG_LEN]
        return ct + tag

    def decrypt(self, nonce: bytes, data: bytes, _aad) -> bytes:
        ct, tag = data[:-_TAG_LEN], data[-_TAG_LEN:]
        want = _hmac.new(self._mac_key, nonce + ct,
                         hashlib.sha256).digest()[:_TAG_LEN]
        if not _hmac.compare_digest(tag, want):
            raise ValueError("authentication tag mismatch")
        return bytes(a ^ b for a, b in
                     zip(ct, self._keystream(nonce, len(ct))))

# Config keys whose string values are encrypted at rest.
_SECRET_KEY_MARKERS = (
    "account_key", "secret", "password", "credentials", "private_key", "token",
)


def generate_key() -> bytes:
    """Fresh 256-bit key (per cluster)."""
    if AESGCM is None:
        return os.urandom(32)
    return AESGCM.generate_key(bit_length=256)


def derive_key(passphrase: str, salt: bytes = b"cloudtik-tpu") -> bytes:
    return hashlib.pbkdf2_hmac("sha256", passphrase.encode(), salt, 100_000)


class AESCipher:
    """AES-256-GCM encrypt/decrypt of strings, base64-armored."""

    def __init__(self, key: bytes, backend: str = "auto"):
        if len(key) not in (16, 24, 32):
            raise ValueError("AES key must be 16/24/32 bytes")
        if backend == "stdlib" or AESGCM is None:
            self._aead = _StdlibAEAD(key)
        else:
            self._aead = AESGCM(key)

    def encrypt(self, plaintext: str) -> str:
        nonce = os.urandom(_NONCE_LEN)
        ct = self._aead.encrypt(nonce, plaintext.encode(), None)
        return base64.b64encode(nonce + ct).decode()

    def decrypt(self, armored: str) -> str:
        raw = base64.b64decode(armored)
        nonce, ct = raw[:_NONCE_LEN], raw[_NONCE_LEN:]
        return self._aead.decrypt(nonce, ct, None).decode()


def _frame_prefix() -> str:
    return _PREFIX if AESGCM is not None else _PREFIX_STDLIB


def _decrypt_framed(value: str, key: bytes) -> str:
    if value.startswith(_PREFIX_STDLIB):
        return AESCipher(key, backend="stdlib").decrypt(
            value[len(_PREFIX_STDLIB):])
    if value.startswith(_PREFIX):
        if AESGCM is None:
            raise RuntimeError(
                "value was encrypted with the AES-GCM backend but "
                "`cryptography` is not installed on this host — backend "
                "skew across the cluster, not a wrong key")
        return AESCipher(key).decrypt(value[len(_PREFIX):])
    return value


def encrypt_string(value: str, key: bytes) -> str:
    return _frame_prefix() + AESCipher(key).encrypt(value)


def decrypt_string(value: str, key: bytes) -> str:
    return _decrypt_framed(value, key)


def is_encrypted(value: Any) -> bool:
    return isinstance(value, str) and \
        value.startswith((_PREFIX, _PREFIX_STDLIB))


def _walk(obj: Any, key_hint: str, fn) -> Any:
    if isinstance(obj, dict):
        return {k: _walk(v, k, fn) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_walk(v, key_hint, fn) for v in obj]
    if isinstance(obj, str):
        return fn(key_hint, obj)
    return obj


def encrypt_config(config: Dict[str, Any], key: bytes) -> Dict[str, Any]:
    """Encrypt secret-looking string values in a config tree.

    Reference parity: utils.py:449.
    """

    cipher = AESCipher(key)

    def enc(key_hint: str, value: str) -> str:
        hint = key_hint.lower()
        if any(m in hint for m in _SECRET_KEY_MARKERS) and not is_encrypted(value):
            return _frame_prefix() + cipher.encrypt(value)
        return value

    return _walk(copy.deepcopy(config), "", enc)


def decrypt_config(config: Dict[str, Any], key: bytes) -> Dict[str, Any]:
    def dec(_key_hint: str, value: str) -> str:
        return _decrypt_framed(value, key)

    return _walk(copy.deepcopy(config), "", dec)
