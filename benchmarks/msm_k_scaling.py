"""MSM filter scaling in k: dense-matrix vs Kronecker-factored transition.

The Hamilton filter's per-step transition apply is either a dense
(2^k, 2^k) matvec (O(4^k)) or k symmetric 2x2 contractions on the
reshaped state (O(k 2^k), `models/msm.py::kron_transition_matvec`).
`filter_states` switches at k > _DENSE_K_MAX (= 6); this benchmark
measures the real crossover on the attached device (VERDICT r03 task #6).

Run: python benchmarks/msm_k_scaling.py  [N]
Prints one line per (k, mode) with warm medians over 5 reps.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(n_steps=1135):
    from copula_var.models import msm
    from copula_var.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    import jax

    rng = np.random.default_rng(0)
    r = rng.standard_normal(int(n_steps))
    print(f"platform={jax.devices()[0].platform} N={n_steps}")
    for k in (4, 6, 8, 10, 12):
        for dense in (True, False):
            try:
                ll = msm.log_likelihood(k, 0.45, 1.0, 5.0, 0.4, r,
                                        dense=dense)
                float(ll)  # compile + warm
                ts = []
                for _ in range(5):
                    t0 = time.time()
                    float(msm.log_likelihood(k, 0.45, 1.0, 5.0, 0.4, r,
                                             dense=dense))
                    ts.append(time.time() - t0)
                ts.sort()
                print(f"k={k:2d} states={2**k:5d} "
                      f"{'dense' if dense else 'kron '} "
                      f"median {ts[2]*1e3:8.2f} ms  min {ts[0]*1e3:8.2f}",
                      flush=True)
            except Exception as e:
                print(f"k={k:2d} {'dense' if dense else 'kron '} "
                      f"FAIL {type(e).__name__}: {str(e)[:100]}", flush=True)


if __name__ == "__main__":
    main(*map(int, sys.argv[1:]))
