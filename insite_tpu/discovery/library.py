"""Candidate-function libraries for sparse ODE discovery.

The discovered model in this framework is just ``(coefficients, library)`` —
the feature matrix is evaluated directly from exponent tuples, so the
sympy/string round-trip of the reference (pkpd/utils.py:372-417, needed there
because pysindy returns equation strings) disappears entirely; INSITE's
per-patient coefficient optimisation then operates on plain arrays.

Feature ordering matches sklearn/pysindy ``PolynomialLibrary``: bias, then
degree-1 terms in input order, then higher degrees by
``itertools.combinations`` (interaction_only) or
``combinations_with_replacement`` — so printed equations line up with the
reference's `feature_library.get_feature_names()`.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Sequence

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class PolynomialLibrary:
    """Polynomial candidate library (reference default: degree=2,
    interaction_only=True — sindy.py:185-188; ablation: degree=4 full)."""

    n_inputs: int
    degree: int = 2
    interaction_only: bool = True
    include_bias: bool = True
    input_names: tuple = None

    def exponents(self) -> np.ndarray:
        """[n_features, n_inputs] integer exponent matrix."""
        rows = []
        if self.include_bias:
            rows.append(np.zeros(self.n_inputs, dtype=np.int32))
        comb = (itertools.combinations if self.interaction_only
                else itertools.combinations_with_replacement)
        for deg in range(1, self.degree + 1):
            for idxs in comb(range(self.n_inputs), deg):
                e = np.zeros(self.n_inputs, dtype=np.int32)
                for i in idxs:
                    e[i] += 1
                rows.append(e)
        return np.stack(rows)

    @property
    def n_features(self) -> int:
        return self.exponents().shape[0]

    def feature_names(self, input_names: Sequence[str] = None) -> list:
        names = (list(input_names) if input_names is not None
                 else (list(self.input_names) if self.input_names
                       else [f'x{i}' for i in range(self.n_inputs)]))
        out = []
        for e in self.exponents():
            if e.sum() == 0:
                out.append('1')
                continue
            parts = []
            for i, p in enumerate(e):
                if p == 1:
                    parts.append(names[i])
                elif p > 1:
                    parts.append(f'{names[i]}^{p}')
            out.append(' '.join(parts))
        return out

    def __call__(self, X):
        """Evaluate the feature matrix.

        X: [..., n_inputs] -> [..., n_features].  Monomials are built by
        unrolled column products (static shapes, XLA fuses the handful of
        multiplies into one kernel).
        """
        exps = self.exponents()
        cols = []
        for e in exps:
            col = jnp.ones(X.shape[:-1], X.dtype)
            for i, p in enumerate(e):
                for _ in range(int(p)):
                    col = col * X[..., i]
            cols.append(col)
        return jnp.stack(cols, axis=-1)

    def pretty_equation(self, coefs, input_names=None, min_coef=1e-3,
                        quantize_round_to=None) -> str:
        """Equation string like the reference's
        ``convert_sindy_model_to_sympyjax_model_core`` output
        (pkpd/utils.py:378-397)."""
        names = self.feature_names(input_names)
        parts = []
        for c, n in zip(np.asarray(coefs).ravel(), names):
            if abs(c) > min_coef:
                if quantize_round_to is not None:
                    c = round(float(c), quantize_round_to)
                term = f'+{c}*{n.replace(" ", "*")}'
                parts.append(term)
        return ''.join(parts) if parts else '0.0'
