"""Does XLA materialize KL's ratio U = A / (W H + eps) on this device?

Compiles the production chunked KL products (ops/kl.py::kl_uht, kl_wtu)
at the headline shape 57600x38400 f32 k=32 with the auto row chunk, then
reports the compiled temporary memory of each: a materialized (chunk, n)
f32 slab of U (or of W H) shows up as at least chunk*n*4 bytes of
temporaries; a ratio fused into the matrix product leaves only small ones.
Prints the instructions whose result is chunk x n, and writes the
optimized HLO of both products into OUT_DIR when one is given.

Run: python tools/kl_hlo_probe.py [OUT_DIR]
"""
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    from pydnmfk_tpu.ops.kl import kl_uht, kl_wtu
    from pydnmfk_tpu.ops.linalg import error_chunk_rows
    m, n, k = 57600, 38400, 32
    chunk = error_chunk_rows(m, n)
    eps = 1.1920929e-07
    spec = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    slab = chunk * n * 4
    print(f"device: {jax.devices()[0].device_kind}; chunk={chunk} rows, "
          f"one (chunk, n) f32 slab = {slab} B", flush=True)
    out_dir = sys.argv[1] if len(sys.argv) > 1 else None
    for name, fn in (("kl_uht", kl_uht), ("kl_wtu", kl_wtu)):
        compiled = jax.jit(lambda a, w, h: fn(a, w, h, eps, chunk)).lower(
            spec(m, n), spec(m, k), spec(k, n)).compile()
        temp = compiled.memory_analysis().temp_size_in_bytes
        text = compiled.as_text()
        big = sorted(set(re.findall(
            rf"(\S+) = f32\[{chunk},{n}\]\{{[^}}]*\}} (\w+)\(", text)))
        print(f"{name}: temp {temp} B ({temp / slab!r} slabs); "
              f"instructions with a [{chunk},{n}] f32 result: {big}",
              flush=True)
        if out_dir:
            with open(os.path.join(out_dir, f"{name}_hlo.txt"), "w") as f:
                f.write(text)


if __name__ == "__main__":
    main()
