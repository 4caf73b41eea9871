"""LDAP simple-bind authenticator — the directory-backed login module; the
port's own copy of ``h2o3_tpu/api/ldap_auth.py`` (standard library only).

Reference: ``water/H2O.java:242-266`` wires ``-ldap_login`` to a JAAS
``LdapLoginModule`` (and ``h2o-jaas-pam`` adds PAM); the server then gates
every request through that login. Here the same contract is a pure-Python
LDAPv3 simple bind (RFC 4511 BindRequest over a socket, BER-encoded by
hand — this image carries no ldap3/python-ldap) plugged into
``H2OServer(authenticator=...)``, the hook Basic/form auth already speak.

Usage (the port has no ``launch.py`` yet; pass the authenticator to the
server)::

    from h2o3_tpu_torch.api import H2OServer
    from h2o3_tpu_torch.api.ldap_auth import ldap_authenticator
    H2OServer(authenticator=ldap_authenticator(
        "ldap://ldap.example.org:389",
        "uid={},ou=people,dc=example,dc=org")).start()

A login attempt binds as the templated DN with the presented password;
resultCode 0 authenticates, anything else (49 invalidCredentials, ...)
rejects. Failures — connection refused, malformed reply — reject closed.
"""

from __future__ import annotations

import socket
from urllib.parse import urlparse

__all__ = ["ldap_authenticator", "ldap_simple_bind"]


# -- minimal BER (the three forms a simple bind needs) -----------------------

def _ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _tlv(tag: int, payload: bytes) -> bytes:
    return bytes([tag]) + _ber_len(len(payload)) + payload


def _read_tlv(buf: bytes, pos: int) -> tuple[int, bytes, int]:
    """(tag, value, next_pos); raises ValueError on truncation."""
    if pos + 2 > len(buf):
        raise ValueError("truncated BER element")
    tag = buf[pos]
    length = buf[pos + 1]
    pos += 2
    if length & 0x80:
        nb = length & 0x7F
        if nb == 0 or pos + nb > len(buf):
            raise ValueError("bad BER length")
        length = int.from_bytes(buf[pos:pos + nb], "big")
        pos += nb
    if pos + length > len(buf):
        raise ValueError("truncated BER value")
    return tag, buf[pos:pos + length], pos + length


def bind_request(msg_id: int, dn: str, password: str) -> bytes:
    """RFC 4511 §4.2: [APPLICATION 0] { version 3, name, simple pw }."""
    op = _tlv(0x60, _tlv(0x02, b"\x03")
              + _tlv(0x04, dn.encode())
              + _tlv(0x80, password.encode()))
    return _tlv(0x30, _tlv(0x02, bytes([msg_id])) + op)


def parse_bind_response(data: bytes) -> int:
    """resultCode of a BindResponse ([APPLICATION 1]); raises on junk."""
    tag, msg, _ = _read_tlv(data, 0)
    if tag != 0x30:
        raise ValueError("not an LDAPMessage")
    pos = 0
    tag, _mid, pos = _read_tlv(msg, pos)          # messageID
    tag, op, _ = _read_tlv(msg, pos)
    if tag != 0x61:
        raise ValueError(f"not a BindResponse (tag {tag:#x})")
    tag, code, _ = _read_tlv(op, 0)               # ENUMERATED resultCode
    if tag != 0x0A:
        raise ValueError("BindResponse without resultCode")
    return int.from_bytes(code, "big")


def ldap_simple_bind(url: str, dn: str, password: str,
                     timeout: float = 5.0) -> bool:
    """One LDAPv3 simple bind; True iff the directory says success (0).

    Empty passwords are rejected HERE: RFC 4513 §5.1.2 calls an empty
    simple password an *unauthenticated* bind that many servers accept
    with resultCode 0 — treating that as login would let anyone in as
    any user (the reference JAAS module guards the same way).
    """
    if not password:
        return False
    u = urlparse(url)
    if u.scheme not in ("ldap", "ldaps"):
        raise ValueError(f"unsupported LDAP url scheme {u.scheme!r}")
    host, port = u.hostname, u.port or (636 if u.scheme == "ldaps" else 389)
    try:
        with socket.create_connection((host, port), timeout=timeout) as s:
            if u.scheme == "ldaps":
                import ssl
                s = ssl.create_default_context().wrap_socket(
                    s, server_hostname=host)
            s.settimeout(timeout)
            s.sendall(bind_request(1, dn, password))
            data = b""
            # read until the outer LDAPMessage TLV is complete (responses
            # with long diagnostics/referrals exceed any fixed byte cap)
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
                try:
                    _, msg, end = _read_tlv(data, 0)
                except ValueError:
                    continue        # header/body still partial
                return parse_bind_response(data[:end]) == 0
    except (OSError, ValueError):
        return False                # closed on any transport/format failure
    return False


def ldap_authenticator(url: str, user_template: str):
    """``(user, password) -> bool`` closure for ``H2OServer(authenticator=)``.

    ``user_template`` holds one ``{}`` that receives the login name, e.g.
    ``uid={},ou=people,dc=example,dc=org``. Login names with DN
    metacharacters are escaped per RFC 4514 before templating.
    """
    if "{}" not in user_template:
        raise ValueError("user template needs a {} placeholder, e.g. "
                         "'uid={},ou=people,dc=example,dc=org'")

    # short-TTL success cache: clients send Basic credentials on EVERY
    # request (h2o-py polls jobs sub-second), and a fresh TCP+bind per
    # call would hammer the directory. Key = (user, salted pw hash);
    # only successes cache, so revocation takes effect within the TTL.
    import hashlib
    import os as _os
    import threading as _th
    import time as _time
    cache: dict[tuple, float] = {}
    lock = _th.Lock()
    salt = _os.urandom(16)
    ttl = 300.0

    def _escape_dn(v: str) -> str:
        out = []
        for i, ch in enumerate(v):
            if ch in ',+"\\<>;=#':
                out.append("\\" + ch)
            elif ord(ch) < 0x20:
                out.append(f"\\{ord(ch):02x}")
            elif ch == " " and i in (0, len(v) - 1):
                # RFC 4514 §2.4: leading/trailing spaces must be escaped,
                # else the directory trims them and 'alice ' binds as alice
                out.append("\\ ")
            else:
                out.append(ch)
        return "".join(out)

    def authenticate(user: str, password: str) -> bool:
        if not user:
            return False
        key = (user, hashlib.sha256(salt + (password or "").encode())
               .hexdigest())
        now = _time.monotonic()
        with lock:
            exp = cache.get(key)
            if exp is not None and now < exp:
                return True
        ok = ldap_simple_bind(url, user_template.format(_escape_dn(user)),
                              password or "")
        if ok:
            with lock:
                cache[key] = now + ttl
                if len(cache) > 10000:      # bound memory under churn
                    cache.clear()
        return ok

    return authenticate
