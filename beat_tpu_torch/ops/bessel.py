"""
Bessel functions J0 and J1 of the first kind in float64, elementwise on
any device: the rational approximations of the Cephes Math Library
(S. L. Moshier, ``j0.c`` and ``j1.c``), the algorithm behind
``scipy.special.j0/j1``, whose values they match to a few units in the
last place (``tests/test_torch_layered.py``; ``chip_smoke.py`` holds them
against scipy on the card).

``torch.special.bessel_j0/j1`` miss scipy by up to 4e-7 for 5 < x < 25
(measured with torch 2.13 on the CPU; ``chip_smoke.py`` [layered_build]
prints their error on the card), far beyond the 1e-12 the table builders'
Hankel sums need, so the builders call these instead.
"""

from __future__ import annotations

import torch

def _polevl(x, c):
    """Σ c_i x^(n-i) by Horner's rule."""
    acc = torch.full_like(x, c[0])
    for ci in c[1:]:
        acc = acc * x + ci
    return acc


def _p1evl(x, c):
    """The same with a leading coefficient 1 left out of ``c``."""
    acc = x + c[0]
    for ci in c[1:]:
        acc = acc * x + ci
    return acc


_J0_PP = (
    7.96936729297347051624E-4, 8.28352392107440799803E-2, 1.23953371646414299388E0,
    5.44725003058768775090E0, 8.74716500199817011941E0, 5.30324038235394892183E0,
    9.99999999999999997821E-1,
)
_J0_PQ = (
    9.24408810558863637013E-4, 8.56288474354474431428E-2, 1.25352743901058953537E0,
    5.47097740330417105182E0, 8.76190883237069594232E0, 5.30605288235394617618E0,
    1.00000000000000000218E0,
)
_J0_QP = (
    -1.13663838898469149931E-2, -1.28252718670509318512E0, -1.95539544257735972385E1,
    -9.32060152123768231369E1, -1.77681167980488050595E2, -1.47077505154951170175E2,
    -5.14105326766599330220E1, -6.05014350600728481186E0,
)
_J0_QQ = (
    6.43178256118178023184E1, 8.56430025976980587198E2, 3.88240183605401609683E3,
    7.24046774195652478189E3, 5.93072701187316984827E3, 2.06209331660327847417E3,
    2.42005740240291393179E2,
)
_J0_RP = (
    -4.79443220978201773821E9, 1.95617491946556577543E12, -2.49248344360967716204E14,
    9.70862251047306323952E15,
)
_J0_RQ = (
    4.99563147152651017219E2, 1.73785401676374683123E5, 4.84409658339962045305E7,
    1.11855537045356834862E10, 2.11277520115489217587E12, 3.10518229857422583814E14,
    3.18121955943204943306E16, 1.71086294081043136091E18,
)


_DR1, _DR2 = 5.78318596294678452118E0, 3.04712623436620863991E1
_SQ2OPI = 7.9788456080286535587989E-1
_PIO4, _THPIO4 = 7.85398163397448309616E-1, 2.35619449019234492885
_J1_RP = (
    -8.99971225705559398224E8, 4.52228297998194034323E11, -7.27494245221818276015E13,
    3.68295732863852883286E15,
)
_J1_RQ = (
    6.20836478118054335476E2, 2.56987256757748830383E5, 8.35146791431949253037E7,
    2.21511595479792499675E10, 4.74914122079991414898E12, 7.84369607876235854894E14,
    8.95222336184627338078E16, 5.32278620332680085395E18,
)
_J1_PP = (
    7.62125616208173112003E-4, 7.31397056940917570436E-2, 1.12719608129684925192E0,
    5.11207951146807644818E0, 8.42404590141772420927E0, 5.21451598682361504063E0,
    1.00000000000000000254E0,
)
_J1_PQ = (
    5.71323128072548699714E-4, 6.88455908754495404082E-2, 1.10514232634061696926E0,
    5.07386386128601488557E0, 8.39985554327604159757E0, 5.20982848682361821619E0,
    9.99999999999999997461E-1,
)
_J1_QP = (
    5.10862594750176621635E-2, 4.98213872951233449420E0, 7.58238284132545283818E1,
    3.66779609360150777800E2, 7.10856304998926107277E2, 5.97489612400613639965E2,
    2.11688757100572135698E2, 2.52070205858023719784E1,
)
_J1_QQ = (
    7.42373277035675149943E1, 1.05644886038262816351E3, 4.98641058337653607651E3,
    9.56231892404756170795E3, 7.99704160447350683650E3, 2.82619278517639096600E3,
    3.36093607810698293419E2,
)
_Z1, _Z2 = 1.46819706421238932572E1, 4.92184563216946036703E1


def bessel_j0(x: torch.Tensor) -> torch.Tensor:
    """J0(x), elementwise in the dtype of ``x`` (float64 for the stated
    accuracy): a rational function of x² up to 5, the Hankel asymptotic
    form with rational P and Q beyond."""
    x = x.abs()
    small = x <= 5.0
    z = x * x
    p_small = (z - _DR1) * (z - _DR2) * _polevl(z, _J0_RP) / _p1evl(z, _J0_RQ)
    p_small = torch.where(x < 1e-5, 1.0 - z / 4.0, p_small)
    xl = torch.where(small, 10.0, x)      # keeps the unused branch finite
    w = 5.0 / xl
    q = 25.0 / (xl * xl)
    p = _polevl(q, _J0_PP) / _polevl(q, _J0_PQ)
    qq = _polevl(q, _J0_QP) / _p1evl(q, _J0_QQ)
    xn = xl - _PIO4
    big = (p * torch.cos(xn) - w * qq * torch.sin(xn)) * _SQ2OPI / torch.sqrt(xl)
    return torch.where(small, p_small, big)


def bessel_j1(x: torch.Tensor) -> torch.Tensor:
    """J1(x), elementwise, as :func:`bessel_j0`."""
    sgn = torch.sign(x)
    x = x.abs()
    small = x <= 5.0
    z = x * x
    w_small = _polevl(z, _J1_RP) / _p1evl(z, _J1_RQ) * x * (z - _Z1) * (z - _Z2)
    xl = torch.where(small, 10.0, x)
    w = 5.0 / xl
    z2 = w * w
    p = _polevl(z2, _J1_PP) / _polevl(z2, _J1_PQ)
    q = _polevl(z2, _J1_QP) / _p1evl(z2, _J1_QQ)
    xn = xl - _THPIO4
    big = (p * torch.cos(xn) - w * q * torch.sin(xn)) * _SQ2OPI / torch.sqrt(xl)
    return sgn * torch.where(small, w_small, big)
