"""Scoped-token authentication (Globus Auth analogue).

funcX outsources auth to Globus Auth: services are resource servers with
scopes (e.g. ``register_function``) and clients present delegated tokens.
Here a :class:`TokenAuthority` plays the identity provider: it mints
HMAC-signed tokens carrying an identity + scope set, and the
:class:`FunctionService` verifies scope membership per API call. Endpoints
register as clients with the ``register_endpoint`` scope, mirroring funcX's
client_id/secret registration.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import time
from dataclasses import dataclass
from typing import Iterable, Optional

from . import serializer

# Canonical scopes (paper §5.7 uses urn:globus:auth:scope:funcx.org:*)
SCOPE_REGISTER_FUNCTION = "register_function"
SCOPE_INVOKE = "invoke"
SCOPE_REGISTER_ENDPOINT = "register_endpoint"
SCOPE_ADMIN = "admin"
ALL_SCOPES = (
    SCOPE_REGISTER_FUNCTION,
    SCOPE_INVOKE,
    SCOPE_REGISTER_ENDPOINT,
    SCOPE_ADMIN,
)


class AuthError(PermissionError):
    pass


@dataclass(frozen=True)
class TenantProfile:
    """Fabric-level scheduling profile for one identity (the hosted service's
    per-user registration record): `quota` caps the tenant's outstanding
    tasks fabric-wide (None = unlimited; admission rejects beyond it with
    ``retry_after``), `weight` is its deficit-round-robin fair-share ratio.
    Consumed by :class:`~repro.core.fairness.FairnessPolicy` via
    ``bind_profiles``."""

    identity: str
    quota: Optional[int] = None
    weight: float = 1.0


@dataclass(frozen=True)
class Token:
    identity: str
    scopes: tuple
    issued_at: float
    expires_at: float
    signature: bytes

    def to_bytes(self) -> bytes:
        return serializer.packb(
            {
                "identity": self.identity,
                "scopes": list(self.scopes),
                "issued_at": self.issued_at,
                "expires_at": self.expires_at,
                "signature": self.signature,
            }
        )

    @staticmethod
    def from_bytes(data: bytes) -> "Token":
        d = serializer.unpackb(data)
        return Token(
            identity=d["identity"],
            scopes=tuple(d["scopes"]),
            issued_at=d["issued_at"],
            expires_at=d["expires_at"],
            signature=d["signature"],
        )


def _payload_bytes(identity: str, scopes: Iterable[str], issued_at: float, expires_at: float) -> bytes:
    return serializer.packb(
        {"identity": identity, "scopes": sorted(scopes), "ia": issued_at, "ea": expires_at}
    )


class TokenAuthority:
    """Mints and verifies scoped tokens. One per deployment (the 'Globus')."""

    def __init__(self, secret: Optional[bytes] = None):
        self._secret = secret if secret is not None else os.urandom(32)
        self._profiles: dict[str, TenantProfile] = {}

    # -- tenant profiles (fairness tier) ---------------------------------
    def set_tenant_profile(
        self, identity: str, quota: Optional[int] = None, weight: float = 1.0
    ) -> TenantProfile:
        """Declare (or replace) the scheduling profile for `identity`."""
        prof = TenantProfile(identity=identity, quota=quota, weight=weight)
        self._profiles[identity] = prof
        return prof

    def tenant_profile(self, identity: str) -> Optional[TenantProfile]:
        return self._profiles.get(identity)

    def tenant_profiles(self) -> dict[str, TenantProfile]:
        return dict(self._profiles)

    def issue(
        self,
        identity: str,
        scopes: Iterable[str] = (SCOPE_INVOKE,),
        ttl_s: float = 3600.0,
    ) -> Token:
        scopes = tuple(sorted(set(scopes)))
        for s in scopes:
            if s not in ALL_SCOPES:
                raise AuthError(f"unknown scope {s!r}")
        now = time.time()
        sig = hmac.new(
            self._secret, _payload_bytes(identity, scopes, now, now + ttl_s), hashlib.sha256
        ).digest()
        return Token(identity, scopes, now, now + ttl_s, sig)

    def verify(self, token: Optional[Token], required_scope: str) -> str:
        """Returns the authenticated identity; raises AuthError otherwise."""
        if token is None:
            raise AuthError("no token supplied")
        expected = hmac.new(
            self._secret,
            _payload_bytes(token.identity, token.scopes, token.issued_at, token.expires_at),
            hashlib.sha256,
        ).digest()
        if not hmac.compare_digest(expected, token.signature):
            raise AuthError("bad token signature")
        if time.time() > token.expires_at:
            raise AuthError("token expired")
        if required_scope not in token.scopes and SCOPE_ADMIN not in token.scopes:
            raise AuthError(f"token lacks scope {required_scope!r}")
        return token.identity
