"""Encryption parameters (the analogue of SEAL ``EncryptionParameters``).

Mirrors the parameter surface the reference touches at
``/root/reference/src/demo.cc:66-74``: scheme=BFV, ``poly_modulus_degree``
2^12..2^15, ``coeff_modulus = CoeffModulus::BFVDefault(n)``, and
``plain_modulus = 2^b`` (b <= 56). Adds the ``tpu`` chain profile (every
prime < 2^30, one u32 lane per residue).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ops import primes

SCHEME_BFV = "bfv"


@dataclass(frozen=True)
class EncryptionParameters:
    scheme: str = SCHEME_BFV
    poly_modulus_degree: int = 8192
    coeff_modulus: tuple[int, ...] = ()
    plain_modulus: int = 0

    def with_poly_modulus_degree(self, n: int) -> "EncryptionParameters":
        return EncryptionParameters(self.scheme, n, self.coeff_modulus, self.plain_modulus)

    def with_coeff_modulus(self, chain) -> "EncryptionParameters":
        return EncryptionParameters(
            self.scheme, self.poly_modulus_degree, tuple(chain), self.plain_modulus
        )

    def with_plain_modulus(self, t: int) -> "EncryptionParameters":
        return EncryptionParameters(
            self.scheme, self.poly_modulus_degree, self.coeff_modulus, t
        )

    @staticmethod
    def bfv(
        poly_modulus_degree: int,
        plain_modulus: int,
        coeff_modulus=None,
        profile: str = "seal",
    ) -> "EncryptionParameters":
        """Convenience constructor.

        profile="seal": SEAL-4.1-style BFVDefault chain (36..61-bit primes).
        profile="tpu":  <2^30 primes (single-lane residues; fast path).
        """
        if coeff_modulus is None:
            chain = (
                primes.bfv_default(poly_modulus_degree)
                if profile == "seal"
                else primes.tpu_default(poly_modulus_degree)
            )
        else:
            chain = list(coeff_modulus)
        return EncryptionParameters(
            SCHEME_BFV, poly_modulus_degree, tuple(chain), plain_modulus
        )

    def validate(self) -> str:
        """Return "" if valid, else an error message (cf. SEAL's
        ``parameter_error_message``)."""
        n = self.poly_modulus_degree
        if self.scheme != SCHEME_BFV:
            return f"unsupported scheme {self.scheme!r}"
        if n < 2 or n & (n - 1):
            return "poly_modulus_degree must be a power of two"
        if not self.coeff_modulus:
            return "empty coeff_modulus"
        for q in self.coeff_modulus:
            if not primes.is_prime(q):
                return f"coeff modulus {q} is not prime"
            if (q - 1) % (2 * n) != 0:
                return f"coeff modulus {q} is not NTT-friendly (1 mod 2n)"
        if len(set(self.coeff_modulus)) != len(self.coeff_modulus):
            return "coeff modulus primes must be distinct"
        if self.plain_modulus < 2:
            return "plain_modulus must be >= 2"
        if self.plain_modulus.bit_length() > 60:
            return "plain_modulus must be at most 60 bits"
        q = 1
        for qi in self.coeff_modulus:
            q *= qi
        if self.plain_modulus * 4 > q:
            return "plain_modulus too large for the coeff modulus (no noise room)"
        return ""
