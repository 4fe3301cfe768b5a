"""Pluggable REST security (port of cruise_control_tpu/api/security.py).

Reference CC/servlet/security/ (17 files): SecurityProvider SPI with HTTP
Basic, JWT, SPNEGO and trusted-proxy implementations over a three-role
model ADMIN > USER > VIEWER (docs/wiki "Security").  Here: the SPI, the
role model and endpoint→role mapping, an HTTP Basic provider (stdlib
base64), a standards-based `JwtSecurityProvider` (RFC 7515/7519 compact
JWS: HS256 via stdlib hmac, RS256 via the `cryptography` package when
present — reference servlet/security/jwt/JwtLoginService.java:1-226), a
lightweight HMAC signed-token provider (`TokenSecurityProvider`, the
non-JOSE flavor), and a trusted-proxy provider.

**SPNEGO/Kerberos is an explicit non-goal** of this framework: it needs a
live KDC and a Kerberos client stack that this runtime does not carry.
Deployments that require Kerberos should terminate it at a fronting proxy
and use `TrustedProxySecurityProvider` (the reference's own trusted-proxy
flow exists for exactly this topology).
"""
from __future__ import annotations

import abc
import base64
import dataclasses
import enum
import hashlib
import hmac
import json
import time as _time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

from cruise_control_tpu_torch.api.parameters import POST_ENDPOINTS


class Role(enum.IntEnum):
    """VIEWER < USER < ADMIN (reference security docs)."""

    VIEWER = 0
    USER = 1
    ADMIN = 2


#: minimum role per endpoint: viewers see state; users may run GETs that
#: compute; admins mutate (reference DefaultRoleSecurityProvider mapping)
def required_role(endpoint: str) -> Role:
    if endpoint in POST_ENDPOINTS or endpoint == "REVIEW":
        return Role.ADMIN
    if endpoint in ("PROPOSALS", "BOOTSTRAP", "TRAIN"):
        return Role.USER
    return Role.VIEWER


@dataclasses.dataclass(frozen=True)
class Principal:
    name: str
    role: Role


class AuthenticationError(Exception):
    """401 — missing or invalid credentials."""


class AuthorizationError(Exception):
    """403 — authenticated but not permitted."""


class SecurityProvider(abc.ABC):
    """SPI — reference servlet/security/SecurityProvider.java."""

    @abc.abstractmethod
    def authenticate(self, headers: Mapping[str, str]) -> Principal:
        """Return the principal or raise AuthenticationError."""

    def authorize(self, principal: Principal, endpoint: str) -> None:
        if principal.role < required_role(endpoint):
            raise AuthorizationError(
                f"{principal.name} (role {principal.role.name}) may not "
                f"call {endpoint}")

    def auth_challenge_headers(self) -> Mapping[str, str]:
        """Headers attached to 401 responses (e.g. a WWW-Authenticate
        challenge advertising the login provider)."""
        return {}


class NoSecurityProvider(SecurityProvider):
    """Everything allowed (security disabled, the reference default)."""

    def authenticate(self, headers: Mapping[str, str]) -> Principal:
        return Principal("anonymous", Role.ADMIN)


class BasicSecurityProvider(SecurityProvider):
    """HTTP Basic auth against a static credential table (reference
    BasicSecurityProvider reading auth.credentials.file).

    `users` maps username -> (password, Role).
    """

    def __init__(self, users: Mapping[str, Tuple[str, Role]]) -> None:
        self._users = dict(users)

    @staticmethod
    def from_credentials_file(path: str) -> "BasicSecurityProvider":
        """Jetty-property-file flavor: `user: password,ROLE`."""
        users: Dict[str, Tuple[str, Role]] = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                name, rest = line.split(":", 1)
                password, role = rest.rsplit(",", 1)
                users[name.strip()] = (password.strip(),
                                       Role[role.strip().upper()])
        return BasicSecurityProvider(users)

    def authenticate(self, headers: Mapping[str, str]) -> Principal:
        auth = _header(headers, "Authorization")
        if not auth or not auth.startswith("Basic "):
            raise AuthenticationError("missing Basic credentials")
        try:
            decoded = base64.b64decode(auth[6:]).decode()
            name, password = decoded.split(":", 1)
        except Exception:
            raise AuthenticationError("malformed Basic credentials")
        entry = self._users.get(name)
        if entry is None or not hmac.compare_digest(entry[0], password):
            raise AuthenticationError("bad username or password")
        return Principal(name, entry[1])


class TokenSecurityProvider(SecurityProvider):
    """Lightweight HMAC-signed bearer tokens (payload.signature — NOT
    JWT; for standards-based JWT use `JwtSecurityProvider`).  Useful for
    service-to-service auth where both ends are this framework.
    """

    def __init__(self, secret: bytes,
                 time_fn: Optional[Callable[[], float]] = None) -> None:
        self._secret = secret
        self._time = time_fn or _time.time

    # -- token issue (the reference's login service) --
    def issue(self, name: str, role: Role, ttl_s: float = 3600.0) -> str:
        payload = {"sub": name, "role": role.name,
                   "exp": self._time() + ttl_s}
        body = _b64url(json.dumps(payload).encode())
        sig = _b64url(hmac.new(self._secret, body.encode(),
                               hashlib.sha256).digest())
        return f"{body}.{sig}"

    def authenticate(self, headers: Mapping[str, str]) -> Principal:
        auth = _header(headers, "Authorization")
        if not auth or not auth.startswith("Bearer "):
            raise AuthenticationError("missing Bearer token")
        token = auth[7:]
        try:
            body, sig = token.rsplit(".", 1)
            want = _b64url(hmac.new(self._secret, body.encode(),
                                    hashlib.sha256).digest())
            if not hmac.compare_digest(want, sig):
                raise AuthenticationError("bad token signature")
            payload = json.loads(_b64url_decode(body))
        except AuthenticationError:
            raise
        except Exception:
            raise AuthenticationError("malformed token")
        if payload.get("exp", 0) < self._time():
            raise AuthenticationError("token expired")
        return Principal(payload["sub"], Role[payload["role"]])


class JwtSecurityProvider(SecurityProvider):
    """Standards-based JWT bearer authentication (RFC 7519 claims over an
    RFC 7515 compact JWS; reference servlet/security/jwt/
    JwtLoginService.java:1-226 + JwtAuthenticator).

    Supported algorithms: HS256 (shared secret, stdlib hmac) and RS256
    (RSA public key, PKCS#1 v1.5 over SHA-256 via the `cryptography`
    package).  The accepted algorithm set is pinned at construction —
    `alg: none` and algorithm-confusion tokens are rejected outright.

    Claims honored: `exp`/`nbf` (with `leeway_s`), optional expected
    `iss` and `aud`, `sub` as the principal name, and a role claim
    (default `"role"`, values VIEWER/USER/ADMIN; absent → `default_role`).
    """

    def __init__(self, *, hs256_secret: Optional[bytes] = None,
                 rs256_public_key_pem: Optional[bytes] = None,
                 issuer: Optional[str] = None,
                 audience: Optional[str] = None,
                 audiences: Optional[Sequence[str]] = None,
                 cookie_name: Optional[str] = None,
                 login_url: Optional[str] = None,
                 role_claim: str = "role",
                 default_role: Role = Role.USER,
                 leeway_s: float = 30.0,
                 time_fn: Optional[Callable[[], float]] = None) -> None:
        if hs256_secret is None and rs256_public_key_pem is None:
            raise ValueError("JwtSecurityProvider needs an HS256 secret "
                             "and/or an RS256 public key")
        self._hs256_secret = hs256_secret
        self._rs256_key = None
        if rs256_public_key_pem is not None:
            from cryptography.hazmat.primitives.serialization import (
                load_pem_public_key)
            self._rs256_key = load_pem_public_key(rs256_public_key_pem)
        self._issuer = issuer
        #: accepted aud claims (reference jwt.expected.audiences; the
        #: scalar `audience` form merges in)
        self._audiences = ([audience] if audience else []) \
            + list(audiences or [])
        #: cookie carrying the token (reference jwt.cookie.name)
        self._cookie_name = cookie_name
        #: login provider advertised on 401 (reference
        #: jwt.authentication.provider.url)
        self._login_url = login_url
        self._role_claim = role_claim
        self._default_role = default_role
        self._leeway = leeway_s
        self._time = time_fn or _time.time

    def auth_challenge_headers(self) -> Mapping[str, str]:
        if self._login_url:
            return {"WWW-Authenticate":
                    f'Bearer realm="{self._login_url}"'}
        return {"WWW-Authenticate": "Bearer"}

    # -- token issue (test/tooling convenience; the reference's login
    # service issues its tokens out-of-band) --
    def issue_hs256(self, claims: Mapping[str, object]) -> str:
        if self._hs256_secret is None:
            raise ValueError("no HS256 secret configured")
        header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
        body = _b64url(json.dumps(dict(claims)).encode())
        signing_input = f"{header}.{body}".encode()
        sig = _b64url(hmac.new(self._hs256_secret, signing_input,
                               hashlib.sha256).digest())
        return f"{header}.{body}.{sig}"

    def _verify_signature(self, alg: str, signing_input: bytes,
                          sig: bytes) -> None:
        if alg == "HS256" and self._hs256_secret is not None:
            want = hmac.new(self._hs256_secret, signing_input,
                            hashlib.sha256).digest()
            if not hmac.compare_digest(want, sig):
                raise AuthenticationError("bad JWT signature")
            return
        if alg == "RS256" and self._rs256_key is not None:
            from cryptography.exceptions import InvalidSignature
            from cryptography.hazmat.primitives import hashes
            from cryptography.hazmat.primitives.asymmetric import padding
            try:
                self._rs256_key.verify(sig, signing_input,
                                       padding.PKCS1v15(), hashes.SHA256())
            except InvalidSignature:
                raise AuthenticationError("bad JWT signature")
            return
        raise AuthenticationError(f"JWT algorithm {alg!r} not accepted")

    def _token_from_cookie(self, headers: Mapping[str, str]
                           ) -> Optional[str]:
        if not self._cookie_name:
            return None
        raw = _header(headers, "Cookie") or ""
        for part in raw.split(";"):
            name, _, value = part.strip().partition("=")
            if name == self._cookie_name and value:
                return value
        return None

    def authenticate(self, headers: Mapping[str, str]) -> Principal:
        auth = _header(headers, "Authorization")
        if auth and auth.startswith("Bearer "):
            token = auth[7:].strip()
        else:
            token = self._token_from_cookie(headers)
            if not token:
                raise AuthenticationError("missing Bearer token")
        parts = token.split(".")
        if len(parts) != 3:
            raise AuthenticationError("malformed JWT")
        try:
            header = json.loads(_b64url_decode(parts[0]))
            claims = json.loads(_b64url_decode(parts[1]))
            sig = _b64url_decode(parts[2])
        except Exception:
            raise AuthenticationError("malformed JWT")
        if not isinstance(header, dict) or not isinstance(claims, dict):
            raise AuthenticationError("malformed JWT")
        alg = header.get("alg")
        signing_input = f"{parts[0]}.{parts[1]}".encode()
        self._verify_signature(alg, signing_input, sig)

        now = self._time()

        def _numeric(name):
            try:
                return float(claims[name])
            except (TypeError, ValueError):
                # must surface as 401, not a generic ValueError (the
                # server maps ValueError to 400 bad-parameter)
                raise AuthenticationError(f"malformed {name} claim")

        if "exp" in claims and now > _numeric("exp") + self._leeway:
            raise AuthenticationError("JWT expired")
        if "nbf" in claims and now < _numeric("nbf") - self._leeway:
            raise AuthenticationError("JWT not yet valid")
        if self._issuer is not None and claims.get("iss") != self._issuer:
            raise AuthenticationError("JWT issuer mismatch")
        if self._audiences:
            aud = claims.get("aud")
            auds = aud if isinstance(aud, list) else [aud]
            if not any(a in auds for a in self._audiences):
                raise AuthenticationError("JWT audience mismatch")
        sub = claims.get("sub")
        if not sub:
            raise AuthenticationError("JWT missing sub claim")
        role_name = claims.get(self._role_claim)
        try:
            role = (Role[str(role_name).upper()] if role_name
                    else self._default_role)
        except KeyError:
            raise AuthenticationError(f"unknown role {role_name!r}")
        return Principal(str(sub), role)


class TrustedProxySecurityProvider(SecurityProvider):
    """Authenticates a fronting proxy and trusts its asserted user
    (reference TrustedProxySecurityProvider: the proxy authenticates via
    its own provider and passes the end user in `doAs`)."""

    def __init__(self, proxy_provider: SecurityProvider,
                 trusted_proxies: Sequence[str],
                 role_fn: Callable[[str], Role] = lambda name: Role.USER,
                 ip_regex: Optional[str] = None
                 ) -> None:
        import re
        self._proxy_provider = proxy_provider
        self._trusted = set(trusted_proxies)
        self._role_fn = role_fn
        #: source-address filter (reference
        #: trusted.proxy.services.ip.regex): the asserting proxy must
        #: connect from a matching address; the server passes the peer
        #: address as the X-Remote-Addr pseudo-header
        self._ip_re = re.compile(ip_regex) if ip_regex else None

    def authenticate(self, headers: Mapping[str, str]) -> Principal:
        proxy = self._proxy_provider.authenticate(headers)
        if proxy.name not in self._trusted:
            raise AuthenticationError(
                f"{proxy.name} is not a trusted proxy")
        if self._ip_re is not None:
            addr = _header(headers, "X-Remote-Addr") or ""
            if not self._ip_re.fullmatch(addr):
                raise AuthenticationError(
                    f"proxy address {addr!r} not allowed")
        do_as = _header(headers, "doAs") or _header(headers, "X-DoAs-User")
        if not do_as:
            raise AuthenticationError("trusted proxy must assert doAs user")
        return Principal(do_as, self._role_fn(do_as))


def _header(headers: Mapping[str, str], name: str) -> Optional[str]:
    for k, v in headers.items():
        if k.lower() == name.lower():
            return v
    return None


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))
