"""How `correct` is decided: the program's results of a sample of the
window's calls against the reference's, worked out again from the same
seeds (`reference.protocols`), each number against its limit.

The numbers, each the worst over the results compared (a result is one
fit, one start of a batch, or one validation pass):

* ``param``: ||p - r|| / ||r|| of the fitted variational parameters
  (the objective's gradient and the optimizer, through the fit);
* ``d2``: |d2_p - d2_r| / |d2_r|, the 2-divergence bound (the
  log-weights' statistics, the combine and the bound algebra);
* ``W2``: |W2_p - W2_r| / |W2_r| (with q's closed-form moments);
* ``khat``: |khat_p - khat_r| (the PSIS tail fit);
* ``psis_mean``: ||m_p - m_r|| / sqrt(tr S_r), the PSIS-corrected mean
  on the scale of the reference's q (S_r its covariance): the smoothed
  weights and the weighted moments.

A reference result may carry a ``witness``: the reference replayed in
the configuration's precision (`kinds/multistart.py`).  A result whose
witness itself fails a tenth of the limits against the reference is
one that the configuration's arithmetic cannot be held to: it is
excused, and reads 0 on every number.

A number that is not finite fails.  The limits sit in
``limits/<workload>.json``, which names the numbers a cell compares (a
number whose control does not read well above the program's sound runs
separates nothing and is not compared); PERF.md gives the readings each
limit was set from.
"""
import math

import numpy as np
import torch

NUMBERS = ('param', 'd2', 'W2', 'khat', 'psis_mean')
WITNESS_SHARE = 0.1


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().to('cpu', torch.float64).numpy()
    return np.asarray(v, dtype=np.float64)


def _rel(a, b):
    if a == b:            # infinite bounds on both sides agree
        return 0.0
    return float(abs(a - b) / abs(b)) if b != 0 else math.inf


def _abs(a, b):
    return 0.0 if a == b else abs(a - b)


def gaps(prog, ref):
    """The numbers of one program result against the reference's."""
    p, r = _host(prog['param']), _host(ref['param'])
    return dict(
        param=float(np.linalg.norm(p - r) / np.linalg.norm(r)),
        d2=_rel(float(prog['d2']), float(ref['d2'])),
        W2=_rel(float(prog['W2']), float(ref['W2'])),
        khat=_abs(float(_host(prog['khat'])), float(ref['khat'])),
        psis_mean=float(np.linalg.norm(_host(prog['psis_mean'])
                                       - _host(ref['psis_mean']))
                        / ref['q_scale']))


def excused(ref, limits):
    """Whether the reference's own witness fails a tenth of `limits`:
    the program follows its float32 replay far closer than tenfold, so a
    result whose witness passes that is held to the whole limits, and
    one that float32 arithmetic takes far from float64 is not."""
    return 'witness' in ref and not judge(
        gaps(ref['witness'], ref),
        {k: WITNESS_SHARE * v for k, v in limits.items()})[0]


def worst(pairs, limits=None):
    """Each number's largest gap over the (program, reference) pairs that
    `limits` do not excuse; a NaN anywhere stays NaN."""
    out = {k: 0.0 for k in NUMBERS}
    for prog, ref in pairs:
        if limits is not None and excused(ref, limits):
            continue
        for k, v in gaps(prog, ref).items():
            if not math.isnan(out[k]) and (math.isnan(v) or v > out[k]):
                out[k] = v
    return out


def judge(readings, limits):
    """``(correct, checks)``: every number that the cell's limits name
    finite and at most its limit; `checks` maps each to its value and
    limit."""
    checks = {k: dict(value=readings[k], limit=limits[k]) for k in NUMBERS
              if k in limits}
    ok = all(math.isfinite(c['value']) and c['value'] <= c['limit']
             for c in checks.values())
    return ok, checks
