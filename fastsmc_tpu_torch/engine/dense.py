"""Dense transition-operator construction.

The reference decodes with O(K)-per-step recurrences (alphaC suffix sums and
AU/BU affine chains, HMM.cpp:787-879/943-1041) because dense K x K matvecs
are expensive on CPU SIMD. Batched over P pairs, a dense [K, K] @ [K, P]
product is the fastest formulation on an accelerator, so (as
``fastsmc_tpu/engine/dense.py``, of which this is the port's copy) we
reconstruct the exact dense operators implied by the D/B/U/RR/CR
factorisation:

forward operator  Tf   (next[k] = sum_j Tf[k, j] * prev[j]):
    Tf[k, j] = U[j] * prod_{m=j+1}^{k-1} CR[m]   for j < k   (AU recurrence)
    Tf[k, k] = D[k]
    Tf[k, j] = B[k]                              for j > k   (B * alphaC)

backward operator Tb   (prev[k] = sum_j Tb[k, j] * vec[j]):
    Tb[k, j] = B[j]                              for j < k   (BL prefix)
    Tb[k, k] = D[k]
    Tb[k, j] = U[j-1] * prod_{m=k}^{j-2} RR[m]   for j > k   (BU recurrence)

Both are built with float32 multiply chains in the same order as the
reference recurrences, so the only numerical difference from the reference
is the summation order of the final dot product.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def build_dense_operators(D: np.ndarray, B: np.ndarray, U: np.ndarray,
                          RR: np.ndarray, CR: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Build forward/backward dense operators for a stack of rows.

    D, B, U, RR: float32 [G, K] (B/U/RR zero-padded in the last column);
    CR: float32 [K].  Returns (Tf [G, K, K], Tb [G, K, K]) float32.
    """
    D = np.asarray(D, np.float32)
    B = np.asarray(B, np.float32)
    U = np.asarray(U, np.float32)
    RR = np.asarray(RR, np.float32)
    CR = np.asarray(CR, np.float32)
    G, K = D.shape

    Tf = np.zeros((G, K, K), dtype=np.float32)
    # upper triangle: row-constant B[k]
    iu = np.triu_indices(K, 1)
    Tf[:, iu[0], iu[1]] = B[:, iu[0]]
    # diagonal
    dk = np.arange(K)
    Tf[:, dk, dk] = D
    # lower triangle via the AU recurrence:
    # row k: coeff[j] = CR[k-1] * coeff_{k-1}[j] for j < k-1; coeff[k-1] = U[k-1]
    row = np.zeros((G, K), dtype=np.float32)
    for k in range(1, K):
        row = row * CR[k - 1]
        row[:, k - 1] = U[:, k - 1]
        Tf[:, k, :k] = row[:, :k]

    Tb = np.zeros((G, K, K), dtype=np.float32)
    # lower triangle: column-constant B[j]
    il = np.tril_indices(K, -1)
    Tb[:, il[0], il[1]] = B[:, il[1]]
    Tb[:, dk, dk] = D
    # upper triangle via the BU recurrence:
    # row k: coeff[j] = RR[k] * coeff_{k+1}[j] for j > k+1; coeff[k+1] = U[k]
    row = np.zeros((G, K), dtype=np.float32)
    for k in range(K - 2, -1, -1):
        row = row * RR[:, k:k + 1]
        row[:, k + 1] = U[:, k]
        Tb[:, k, k + 1:] = row[:, k + 1:]

    return Tf, Tb
