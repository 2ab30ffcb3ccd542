"""The catalog's differentiable entries and the domains where the gradient
tests sample them (``test_torch_autodiff.py`` against JAX on the CPU,
``test_torch_cuda_builtins.py``'s backward kernels against their plain forms on
the card)."""

from chip_smoke import BUILTIN_DOMAIN, BUILTIN_INTEGER

#: the catalog entries whose result is not a float (or whose operand is
#: an integer code), and nextafter, which JAX does not differentiate ...
NOT_DIFFERENTIABLE = {
    "isnan", "isinf", "isfinite", "isnormal", "signbit", "isequal",
    "isnotequal", "isgreater", "isgreaterequal", "isless", "islessequal",
    "islessgreater", "isordered", "isunordered", "ilogb", "frexp_exp",
    "gamma_sign", "any", "all", "nan", "nextafter", *BUILTIN_INTEGER}
#: ... and interior domains where BUILTIN_DOMAIN reaches a pole or an edge
#: of the derivative (tan at pi/2, sqrt at 0, asin at 1, gamma's poles)
GRAD_DOMAIN = {**BUILTIN_DOMAIN, "tan": (-1.2, 1.2), "tanpi": (-0.4, 0.4),
               "asin": (-0.9, 0.9), "acos": (-0.9, 0.9),
               "asinpi": (-0.9, 0.9), "acospi": (-0.9, 0.9),
               "atanh": (-0.9, 0.9), "acosh": (1.1, 3.0),
               "sqrt": (0.05, 4.0), "tgamma": (0.2, 4.0),
               "lgamma": (0.2, 5.0), "log1p": (-0.5, 3.0)}
