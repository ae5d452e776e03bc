"""The r=8192 Bloom regime (SURVEY hard part #4): 67,108,864 device inserts.

Reference accepts r up to 8192 (/root/reference/src/demo.cc:115-125); its
insert loop is scalar C++. Here: device batch insert in 1M-key chunks
(scatter-OR), sampled membership probe, serialize/deserialize roundtrip.
Run on the GPU (`python scripts/run_bloom_r8192.py`); prints JSONL wall times.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from pplp_tpu.utils.chipstate import enable_compile_cache

enable_compile_cache()


def main():
    from pplp_tpu.primitives.bloom import BloomFilter, BloomParameters

    r = 8192
    count = r * r  # 67,108,864
    t0 = time.time()
    params = BloomParameters(
        projected_element_count=count,
        false_positive_probability=1e-4,
        random_seed=0xA5A5A5A5,
    )
    assert params.compute_optimal_parameters()
    bf = BloomFilter(params)
    print(json.dumps({"stage": "params", "table_bits": bf.table_size,
                      "hashes": len(bf.salts),
                      "s": round(time.time() - t0, 2)}), flush=True)

    s_blind, w, wlen = 0x9E3779B1, 0x5A5A, 16
    chunk = 1 << 22  # 4M keys per host->device slab (keys generated on host)
    t_ins = time.time()
    for start in range(0, count, chunk):
        di = np.arange(start, start + chunk, dtype=np.uint64)
        keys = ((np.uint64(s_blind) * (di + np.uint64(r))) << np.uint64(wlen)
                ) | np.uint64(w)
        klo = jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        khi = jnp.asarray((keys >> np.uint64(32)).astype(np.uint32))
        bf.insert_u64_batch(klo, khi)
    jax.block_until_ready(bf._bits_device())
    dt = time.time() - t_ins
    print(json.dumps({"stage": "insert", "keys": count,
                      "s": round(dt, 2),
                      "inserts_per_s": round(count / dt, 0)}), flush=True)

    # Membership: every sampled inserted key must be present.
    t_probe = time.time()
    rng = np.random.default_rng(3)
    di = rng.integers(0, count, size=100_000).astype(np.uint64)
    keys = ((np.uint64(s_blind) * (di + np.uint64(r))) << np.uint64(wlen)
            ) | np.uint64(w)
    klo = jnp.asarray((keys & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    khi = jnp.asarray((keys >> np.uint64(32)).astype(np.uint32))
    got = np.asarray(bf.contains_u64_batch(klo, khi))
    assert got.all(), "inserted keys must probe positive"
    # False-positive spot check on keys outside the inserted set.
    di_out = rng.integers(count + 1, 1 << 40, size=100_000).astype(np.uint64)
    keys_o = ((np.uint64(s_blind) * (di_out + np.uint64(r))) << np.uint64(wlen)
              ) | np.uint64(w)
    klo_o = jnp.asarray((keys_o & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    khi_o = jnp.asarray((keys_o >> np.uint64(32)).astype(np.uint32))
    fp = float(np.asarray(bf.contains_u64_batch(klo_o, khi_o)).mean())
    print(json.dumps({"stage": "probe", "sampled": 100_000,
                      "all_present": True, "fp_rate": fp,
                      "s": round(time.time() - t_probe, 2)}), flush=True)

    # Streamed serialize -> socket (round-5, VERDICT r4 task 5): chunked
    # device fetch overlapped with the wire transfer, exactly the protocol's
    # send_bf path. A reader thread drains a socketpair.
    import socket
    import threading

    from pplp_tpu.protocol.transport import Channel

    s1, s2 = socket.socketpair()
    tx, rx = Channel(s1), Channel(s2)
    got = {}
    th = threading.Thread(target=lambda: got.update(b=rx.recv_frame()))
    th.start()
    t_ser = time.time()
    total = bf.compute_serialization_size()
    tx.send_frame_stream(total, bf.iter_serialized())
    th.join()
    dt_stream = time.time() - t_ser
    blob = got["b"]
    s1.close(), s2.close()
    assert len(blob) == total
    print(json.dumps({"stage": "serialize_stream_send", "bytes": len(blob),
                      "s": round(dt_stream, 2)}), flush=True)
    # One-shot serialize for comparison (host cache is warm now -> cheap;
    # the number of record is the streamed stage above).
    t_ser = time.time()
    blob = bf.serialize()
    print(json.dumps({"stage": "serialize_cached", "bytes": len(blob),
                      "s": round(time.time() - t_ser, 2)}), flush=True)
    t_de = time.time()
    bf2 = BloomFilter.deserialize(blob)
    probe = rng.integers(0, count, size=50)
    di_p = probe.astype(np.uint64)
    keys_p = ((np.uint64(s_blind) * (di_p + np.uint64(r))) << np.uint64(wlen)
              ) | np.uint64(w)
    assert all(bf2.contains_u64(int(k)) for k in keys_p)
    print(json.dumps({"stage": "deserialize_probe", "ok": True,
                      "s": round(time.time() - t_de, 2),
                      "total_s": round(time.time() - t0, 2)}), flush=True)


if __name__ == "__main__":
    main()
