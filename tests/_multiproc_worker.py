"""Worker for the 2-process jax.distributed test (test_distributed.py).

Each process contributes 2 virtual CPU devices; the pair forms a global
4-device runtime through a real coordinator/worker handshake — the same
`jax.distributed.initialize` path a multi-host cluster takes (SURVEY.md T9),
on the CPU backend. Run as: python _multiproc_worker.py <pid> <port>.
"""

import os
import sys

pid, port = int(sys.argv[1]), sys.argv[2]

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flashattn_tpu.parallel.distributed import initialize_distributed  # noqa: E402

initialize_distributed(f"localhost:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.devices()
assert len(jax.local_devices()) == 2

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

mesh = Mesh(np.array(jax.devices()).reshape(4), ("sp",))

# 1. A cross-process collective: global sum over a device-sharded iota.
sharding = NamedSharding(mesh, P("sp"))
arr = jax.make_array_from_callback(
    (4,), sharding, lambda idx: np.asarray(np.arange(4)[idx], np.float32))
total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(arr)
assert float(total) == 6.0, float(total)

# 2. A real library op whose ppermute ring crosses the process boundary:
# ring attention over the 4-device sp axis vs the local oracle.
from flashattn_tpu.ops.reference import reference_attention  # noqa: E402
from flashattn_tpu.parallel.ring import ring_flash_attention  # noqa: E402
from flashattn_tpu.ops.common import BlockSizes  # noqa: E402

bs = BlockSizes(block_q=32, block_kv=32, block_q_dq=32, block_kv_dq=32,
                block_q_dkv=32, block_kv_dkv=32)
ks = jax.random.split(jax.random.PRNGKey(0), 3)
q, k, v = (jax.random.normal(kk, (1, 2, 128, 32)) for kk in ks)
spec = P(None, None, "sp", None)
fn = jax.jit(jax.shard_map(
    lambda q, k, v: ring_flash_attention(q, k, v, axis_name="sp",
                                         is_causal=True, block_sizes=bs,
                                         interpret=True),
    mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False))
q_s, k_s, v_s = (jax.device_put(x, NamedSharding(mesh, spec))
                 for x in (q, k, v))
o = fn(q_s, k_s, v_s)
o_local = np.asarray(
    jax.experimental.multihost_utils.process_allgather(o, tiled=True))
o_ref = np.asarray(reference_attention(q, k, v, is_causal=True))
err = float(np.max(np.abs(o_local - o_ref)))
assert err < 1e-5, err

print(f"MULTIPROC_OK pid={pid} devices={jax.device_count()} err={err:.2e}",
      flush=True)
