"""Holding one optimizer step against another: the port's against the JAX
package's, or against the port's own on another path.

Adam's step of an element is about lr * m / sqrt(v): on a first step
lr * g / (|g| + eps), close to lr times the sign of the gradient g
whatever its size. Two steps from the same weights therefore agree to
rounding wherever the gradient is clearly non-zero, and an element whose
gradient is zero up to rounding moves by the sign of that rounding, up
to lr either way. `assert_same_update` tells the two kinds apart by a
rule on the reference's own gradient, never on the difference: every
element whose gradient is exactly zero or exceeds `zero` of its leaf's
largest magnitude has its update ``after - before`` held to `tol` (a
small share of lr), the others to Adam's bound 2 lr. A skipped update
differs by about lr and a reversed one by about 2 lr, far beyond `tol`.
"""

from __future__ import annotations

import numpy as np


def assert_same_update(got_before: dict, got_after: dict, want_before: dict, want_after: dict,
                       grad: dict, lr: float, tol: float, zero: float = 1e-4,
                       max_noise: float = 0.02, what: str = "") -> float:
    """Every leaf named in `grad` (the reference's gradient, by dotted
    name): the update of each element whose gradient is 0 or above `zero`
    of the leaf's largest in magnitude within `tol`, every other within
    2 lr; at most `max_noise` of all elements of the other kind. Returns
    the largest difference of the first kind."""
    worst, noisy, total = 0.0, 0, 0
    for name, g in grad.items():
        g = np.asarray(g)
        diff = np.abs((got_after[name] - got_before[name])
                      - (want_after[name] - want_before[name]))
        noise = (np.abs(g) <= zero * np.abs(g).max()) & (g != 0)
        assert diff.max() <= 2.02 * lr, f"{what} {name}: update differs by {diff.max()}"
        if (~noise).any():
            kept = float(diff[~noise].max())
            assert kept <= tol, f"{what} {name}: update differs by {kept} (tolerance {tol})"
            worst = max(worst, kept)
        noisy += int(noise.sum())
        total += g.size
    assert noisy <= max_noise * total, f"{what}: {noisy} of {total} gradients zero up to rounding"
    return worst
