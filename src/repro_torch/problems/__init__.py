"""Problem registry — named, seeded CSP workload generators.

The PyTorch counterpart of `repro.problems`:

    from repro_torch.problems import generate, generate_batch

    csp  = generate("model_rb", n=24, seed=0, device="cuda")
    csps = generate_batch("model_rb", 32, n=24, seed=0, device="cuda")

Registered families:

    model_rb          Xu–Li Model RB random binary CSPs at the phase transition
    random_binary     classic model-A generator (paper §5.2 grid cells)
    coloring_random   k-coloring of an Erdős–Rényi G(n, p) graph
    coloring_kneser   k-coloring of a Kneser graph K(m, j) (χ = m − 2j + 2)
    pigeonhole        n pigeons into h holes (h = n − 1 ⇒ UNSAT)
    nqueens           n-queens
    sudoku            seeded 9×9 puzzles with a givens-count difficulty knob

Every generator draws from ``numpy.random.default_rng`` exactly as the
reference does, so the same seed yields byte-identical ``cons``/``mask``/
``dom``. ``generate_batch`` seeds instance i with ``(seed, i)``. ``device``
is where the tensors land (default ``"cuda"``); it is not a knob.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Mapping

from repro_torch.core.csp import CSP
from repro_torch.device import Device

Seed = Any  # int or tuple of ints — anything numpy.random.default_rng accepts

#: generator parameters that are not knobs
_NOT_KNOBS = ("seed", "device")


@dataclasses.dataclass(frozen=True)
class ProblemFamily:
    """One registered generator: ``generator(seed=..., device=..., **knobs)``."""

    name: str
    generator: Callable[..., CSP]
    defaults: Mapping[str, Any]
    difficulty_knob: str
    description: str
    deterministic: bool = False  # True: the seed does not affect the instance

    def params(self, **overrides) -> Dict[str, Any]:
        """Resolved knob dict (defaults + overrides), overrides validated."""
        unknown = set(overrides) - set(self.defaults)
        if unknown:
            raise TypeError(
                f"{self.name}: unknown knob(s) {sorted(unknown)}; "
                f"available: {sorted(self.defaults)}"
            )
        return {**self.defaults, **overrides}

    def validate_sweep(self, knobs: Mapping[str, Any]) -> Dict[str, List[Any]]:
        """Validate a sweep-axis mapping (``knob -> scalar | list of values``)
        against this family's knob set and return it normalized to lists:
        `repro_torch.sweeps` runs a spec's ``[problem.knobs]`` through here
        when the spec is parsed, so an unknown knob fails then."""
        unknown = set(knobs) - set(self.defaults)
        if unknown:
            raise TypeError(
                f"{self.name}: unknown sweep knob(s) {sorted(unknown)}; "
                f"available: {sorted(self.defaults)}"
            )
        return {k: list(v) if isinstance(v, (list, tuple)) else [v] for k, v in knobs.items()}

    def generate(self, seed: Seed = 0, device: Device = "cuda", **overrides) -> CSP:
        return self.generator(seed=seed, device=device, **self.params(**overrides))

    def generate_batch(self, count: int, seed: int = 0, device: Device = "cuda",
                       **overrides) -> List[CSP]:
        """``count`` independent instances sharing (n, d): instance i is seeded
        ``(seed, i)``, so it is reproducible and batch-size independent."""
        params = self.params(**overrides)
        return [self.generator(seed=(seed, i), device=device, **params)
                for i in range(count)]


_REGISTRY: Dict[str, ProblemFamily] = {}


def register_problem(name: str, *, difficulty_knob: str, description: str,
                     deterministic: bool = False):
    """Decorator: register ``fn(seed=..., device=..., **knobs) -> CSP`` under
    ``name``. Knob defaults are read off the function signature."""

    def deco(fn: Callable[..., CSP]) -> Callable[..., CSP]:
        defaults = {
            p.name: p.default
            for p in inspect.signature(fn).parameters.values()
            if p.name not in _NOT_KNOBS
        }
        missing = [k for k, v in defaults.items() if v is inspect.Parameter.empty]
        if missing:
            raise TypeError(f"{name}: knobs {missing} need defaults")
        if difficulty_knob not in defaults:
            raise TypeError(f"{name}: difficulty knob {difficulty_knob!r} not a knob")
        _REGISTRY[name] = ProblemFamily(
            name=name, generator=fn, defaults=defaults,
            difficulty_knob=difficulty_knob, description=description,
            deterministic=deterministic,
        )
        return fn

    return deco


def available_problems() -> List[str]:
    return sorted(_REGISTRY)


def get_problem(name: str) -> ProblemFamily:
    if name not in _REGISTRY:
        raise ValueError(f"unknown problem {name!r}; available: {available_problems()}")
    return _REGISTRY[name]


def generate(name: str, seed: Seed = 0, device: Device = "cuda", **overrides) -> CSP:
    """One seeded instance of a registered family."""
    return get_problem(name).generate(seed=seed, device=device, **overrides)


def generate_batch(name: str, count: int, seed: int = 0, device: Device = "cuda",
                   **overrides) -> List[CSP]:
    """``count`` seeded instances sharing (n, d) — ready for
    `Engine.prepare_many` / `repro_torch.core.solve_many`."""
    return get_problem(name).generate_batch(count, seed=seed, device=device, **overrides)


# Import for side effect: each module registers its families.
from . import random_binary as _random_binary  # noqa: E402,F401
from . import coloring as _coloring  # noqa: E402,F401
from . import structured as _structured  # noqa: E402,F401

model_rb = _random_binary.model_rb
model_rb_params = _random_binary.model_rb_params

__all__ = [
    "ProblemFamily",
    "register_problem",
    "available_problems",
    "get_problem",
    "generate",
    "generate_batch",
    "model_rb",
    "model_rb_params",
]
