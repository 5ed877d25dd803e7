"""Block-tridiagonal solve of the 1-D flame's Newton systems (plain
PyTorch twin of kernel K12).

Counterpart of the JAX package's ``ops/blocktridiag.py``: the block
Thomas algorithm, a forward sweep that factors each modified diagonal
block A_i - B_i C'_{i-1} with partial pivoting (the reference's f64
``lu_factor``) and a backward substitution. The kernel
(``kernels/csrc/block_thomas.cu``) runs the same sweep in one thread
block.
"""

from __future__ import annotations

import torch


def solve(B, A, C, d):
    """Solve B_i x_{i-1} + A_i x_i + C_i x_{i+1} = d_i, i = 0..N-1, with
    B_0 = C_{N-1} = 0 (their entries are ignored). B, A, C are [N, M, M]
    and d is [N, M]; returns x [N, M]."""
    N, M = d.shape
    Cp = torch.zeros(M, M, dtype=A.dtype, device=A.device)
    dp = torch.zeros(M, dtype=A.dtype, device=A.device)
    Cps, dps = [], []
    for i in range(N):
        Ahat = A[i] - B[i] @ Cp
        lu, piv = torch.linalg.lu_factor(Ahat)
        rhs = torch.cat([C[i], (d[i] - B[i] @ dp)[:, None]], dim=1)
        sol = torch.linalg.lu_solve(lu, piv, rhs)
        Cp, dp = sol[:, :M], sol[:, M]
        Cps.append(Cp)
        dps.append(dp)
    x = [None] * N
    x_next = torch.zeros(M, dtype=A.dtype, device=A.device)
    for i in range(N - 1, -1, -1):
        x_next = dps[i] - Cps[i] @ x_next
        x[i] = x_next
    return torch.stack(x)
