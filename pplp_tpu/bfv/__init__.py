"""BFV homomorphic encryption engine (RNS/NTT implementation on u32 lanes).

Provides the capability surface the reference obtains from Microsoft SEAL 4.1
(see SURVEY.md §2 "external"): parameters with BFVDefault-style chains,
context, keygen, pk encryption, add/sub/add_plain/multiply_plain, decryption,
and serialization. All polynomial arithmetic runs on 32-bit integer lanes via
``pplp_tpu.ops``.
"""

from .params import EncryptionParameters, SCHEME_BFV
from .context import BFVContext
from .plaintext import Plaintext
from .ciphertext import Ciphertext
from .keys import KeyGenerator, PublicKey, SecretKey
from .encryptor import Encryptor
from .evaluator import Evaluator
from .decryptor import Decryptor

__all__ = [
    "EncryptionParameters",
    "SCHEME_BFV",
    "BFVContext",
    "Plaintext",
    "Ciphertext",
    "KeyGenerator",
    "PublicKey",
    "SecretKey",
    "Encryptor",
    "Evaluator",
    "Decryptor",
]
