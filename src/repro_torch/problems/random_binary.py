"""Random binary CSP families: Model RB (phase transition) + classic model A.

The PyTorch counterpart of `repro.problems.random_binary`: the same numpy
draws in the same order, so a seed gives byte-identical instances.

Model RB (Xu & Li, JAIR 2000) is the standard generator with *proven* exact
satisfiability phase transitions and guaranteed-hard instances at the
threshold — the workload class behind the paper's Table 1 / Fig. 3 evaluation:

    d = ⌈n^alpha⌉                  domain size grows polynomially with n
    m = ⌈r · n · ln n⌉             number of binary constraints
    q = round(p · d²)              disallowed tuples per constraint (exact)

and the (binary, k=2) threshold is at tightness

    p_cr = 1 − exp(−alpha / r)

(instances are a.a.s. satisfiable for p < p_cr, unsatisfiable beyond; the hard
region hugs the threshold). The ``hardness`` knob positions the instance
relative to the threshold: ``p = hardness · p_cr``, so hardness < 1 is the
under-constrained SAT side, 1.0 the transition, > 1 the over-constrained side.

One deliberate deviation from the literature: Model RB samples constraint
*scopes* with repetition, but the dense tensor encoding merges duplicate
scopes into one relation, so we sample ``m`` *distinct* pairs (m is capped at
n(n−1)/2). The declared constraint count is therefore exact — a property the
test suite checks.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.csp import CSP, make_csp, random_csp
from repro_torch.device import Device
from . import register_problem


def model_rb_params(n: int, alpha: float, r: float) -> Tuple[int, int, float]:
    """(dom_size d, #constraints m, critical tightness p_cr) for Model RB."""
    d = max(2, math.ceil(n**alpha))
    m = min(math.ceil(r * n * math.log(n)), n * (n - 1) // 2)
    p_cr = 1.0 - math.exp(-alpha / r)
    return d, m, p_cr


@register_problem(
    "model_rb",
    difficulty_knob="hardness",
    description=(
        "Xu–Li Model RB random binary CSP: d=⌈n^alpha⌉, m=⌈r·n·ln n⌉ distinct "
        "constraint scopes, exactly round(p·d²) disallowed tuples each; "
        "tightness p = hardness · p_cr with p_cr = 1 − e^(−alpha/r)"
    ),
)
def model_rb(
    seed=0,
    n: int = 24,
    alpha: float = 0.8,
    r: float = 0.7,
    hardness: float = 1.0,
    p: Optional[float] = None,
    device: Device = "cuda",
) -> CSP:
    """Model RB instance at tightness ``p`` (default ``hardness · p_cr``).

    Knobs (all sweepable axes; the ``model_rb_phase`` study sweeps n ×
    hardness): ``n`` variables; ``alpha`` sets domain size d = ⌈n^alpha⌉;
    ``r`` sets constraint count m = ⌈r·n·ln n⌉ (distinct scopes, see module
    docstring); ``hardness`` positions tightness relative to the proven
    threshold (< 1 a.a.s. SAT, > 1 a.a.s. UNSAT); ``p`` overrides the
    tightness outright, ignoring hardness."""
    rng = np.random.default_rng(seed)
    d, m, p_cr = model_rb_params(n, alpha, r)
    if p is None:
        p = hardness * p_cr
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"tightness p={p} outside [0, 1]")
    q = int(round(p * d * d))  # exact #disallowed tuples per constraint

    # m distinct scopes, uniform over the n(n-1)/2 unordered pairs
    iu = np.triu_indices(n, k=1)
    pick = rng.choice(len(iu[0]), size=m, replace=False)
    xs, ys = iu[0][pick], iu[1][pick]

    mask = np.zeros((n, n), dtype=bool)
    mask[xs, ys] = True
    mask |= mask.T

    cons = np.zeros((n, n, d, d), dtype=bool)
    for x, y in zip(xs, ys):
        allowed = np.ones((d * d,), dtype=bool)
        allowed[rng.choice(d * d, size=q, replace=False)] = False
        rel = allowed.reshape(d, d)
        cons[x, y] = rel
        cons[y, x] = rel.T  # Cons[y,x,b,a] == Cons[x,y,a,b]

    dom = np.ones((n, d), dtype=bool)
    return make_csp(cons, mask, dom, device=device)


@register_problem(
    "random_binary",
    difficulty_knob="tightness",
    description=(
        "classic model-A random binary CSP (paper §5.2 grid): each pair is "
        "constrained with prob density, each tuple disallowed with prob tightness"
    ),
)
def random_binary(
    seed=0,
    n: int = 50,
    d: int = 20,
    density: float = 0.25,
    tightness: float = 0.3,
    device: Device = "cuda",
) -> CSP:
    """Classic model-A random binary CSP (the paper's §5.2 grid cells).

    Knobs (all sweepable axes; the ``recurrence_density`` study sweeps n ×
    density): ``n`` variables with uniform domain size ``d``; ``density`` is
    the fraction of the n(n−1)/2 variable pairs that get a constraint;
    ``tightness`` the independent probability a value pair is disallowed.
    Unlike Model RB there is no proven threshold — density × tightness
    together set the difficulty."""
    return random_csp(n, d, density=density, tightness=tightness, seed=seed,
                      device=device)
