"""Faults planted in the program's timed path, to show that `correct`
fails them: each ``fault(monkeypatch, cell)`` patches the program through
a `pytest.MonkeyPatch`, before the cell's program objects are built.
The tests plant them under a whole run at small sizes on the CPU;
``python3 -m portbench.calibrate --faults ...`` reads them at a cell's
own sizes on the card.  No cell exchanges between chips, so no fault
leaves an exchange out."""
import viabel_tpu_torch as vt
from viabel_tpu_torch import objectives, optimizers, pipeline
from viabel_tpu_torch.objectives import map_draws


def unchanged_step(monkeypatch, cell):
    """The optimizer step returns the state's parameters unchanged."""
    step = optimizers.adagrad_step

    def frozen(state, *args):
        before = state.param.clone()
        step(state, *args)
        state.param.copy_(before)

    monkeypatch.setattr(optimizers, 'adagrad_step', frozen)


def half_batch(monkeypatch, cell):
    """The objective's mean over the first half of its draws: KLVI's in a
    fit; in a validation pass, the bounds' statistics."""
    klvi = vt.black_box_klvi

    def half_klvi(fam, model, n_mc, presampled=False):
        full = klvi(fam, model, n_mc, presampled)

        def objective(p, draws):
            return full.objective(p, map_draws(
                lambda v: v.narrow(-2, 0, n_mc // 2), draws))

        return objectives._klvi_objective(objective, presampled, fam, n_mc,
                                          model)

    monkeypatch.setattr(vt, 'black_box_klvi', half_klvi)
    all_bounds = vt.all_bounds
    monkeypatch.setattr(vt, 'all_bounds', lambda lw, **kw: all_bounds(
        lw[:lw.shape[0] // 2], **kw))


def altered_answer(monkeypatch, cell):
    """khat moved where PSIS produces it, by twice the cell's khat
    limit."""
    from portbench.run import load_json
    psis_1d, psislw = pipeline._psislw_1d, vt.psislw
    step = 2 * load_json('limits', cell + '.json')['khat']

    def shift(fn):
        def shifted(*args, **kw):
            slw, khat = fn(*args, **kw)
            return slw, khat + step
        return shifted

    monkeypatch.setattr(pipeline, '_psislw_1d', shift(psis_1d))
    monkeypatch.setattr(vt, 'psislw', shift(psislw))


FAULTS = {f.__name__: f for f in (unchanged_step, half_batch,
                                  altered_answer)}
