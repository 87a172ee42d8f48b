"""``chivi_fit``: the ``fit`` loop (`kinds/fit.py`: a closed loop of
`viabel_tpu_torch.validated_vi`, one validated fit a call, and its
``fit_s``) of a configuration whose objective is CHIVI; the reference and
the control replay each checked fit with `reference.chivi`."""
import torch

from portbench.kinds import fit
from portbench.reference import chivi

end_to_end = fit.end_to_end


class Loop(fit.Loop):
    def check(self, ref, seed, out):
        return [chivi.fit(ref, seed, torch.as_tensor(self.init_host))]

    def control_pairs(self, ctl, ref, seed):
        init = torch.as_tensor(self.init_host)
        return [(chivi.fit(ctl, seed, init), chivi.fit(ref, seed, init))]
