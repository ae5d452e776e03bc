"""pplp_tpu — privacy-preserving location proximity on one NVIDIA GPU.

A from-scratch JAX reimplementation of the capabilities of the C++
reference ``phanen/pplp`` (see SURVEY.md): a BFV homomorphic-encryption engine
(RNS limb arithmetic over 32-bit lanes, negacyclic NTT/INTT, keygen, encrypt,
evaluate, decrypt), the blinded-squared-distance + Bloom-filter proximity
protocol with its two-party wire format, a DGK additively-homomorphic
comparison back-end, 2PC geometric predicates, and the radius-sweep CSV
benchmark harness.

The compute core is JAX/XLA; everything modular-arithmetic-hot runs on integer
vector lanes as 32-bit limb arithmetic. That design was inherited from the
package's first accelerator target (no 64-bit multiplier; hence the package
name) and is kept for now.
"""

__version__ = "0.1.0"
