"""Sparse matrix subsystem (vexcl/spmat.hpp + vexcl/sparse/*): DIA, CSR,
ELL, hybrid, SELL-R and CCSR."""

from .dia import DIA as dia, try_build_dia
from .formats import CSR, ELL, Hybrid, choose_ell_width, from_csr_host
from .sell import SELLR
from .spmat import (CCSRExpr, SpMat, SpMatCCSR, SpMVExpr, default_format,
                    make_inline, matrix)
