"""The example layer: the port's counterparts of ``examples/*.py``, the
script forms of the reference's notebooks (examples/README.md).

Each module has the JAX example's name, its ``main`` keeps that example's
keyword arguments, printed lines and the keys of the dict it returns, and
each helper the JAX example defines keeps its name and arguments (a
generator in place of a key; where a test feeds shared draws, the draws
or log-weights a generator would give).  Each runs on the CUDA card, or
on the CPU with ``device='cpu'`` / ``--device cpu``; with no card and no
``--device cpu`` it raises.  Run one as

    python -m viabel_tpu_torch.examples.<name> [--full] [--device cpu]

| Module | Reference notebook |
|---|---|
| `normal_mixture` | normal-mixture.ipynb |
| `robust_regression` | robust-regression.ipynb |
| `funnel` | funnel-distribution.ipynb |
| `eight_schools` | eight-schools.ipynb |
| `linear_regression_ia` | linear-regression-model-Iterate-Averaging-rhat.ipynb (and the ``-2`` variant's protocol, ``--protocol2``) |
| `eight_schools_ia` | eight-schools-iterate-averaging-rhat.ipynb (and eight_schools.ipynb's full-rank family, ``--full-rank``) |
| `chivi_experiments` | chivi_expts.ipynb / chive_expts_2.ipynb / chive_expts_3.ipynb |
| `multistart_pipeline` | none: K starts of validated VI as one batch, the best chosen by the validated d2 |
| `pod_layout` | none: the mesh layouts (sample-sharded bounds, the 2-D multistart, IA and HMC chains over a chain axis), on one card listed several times or over ranks (``--distributed``) |
| `large_d` | none: full-rank validated VI at d = 100 / 300 |

Where the JAX example's objective samples inside its step, the port's is
presampled: the JAX package's `make_draws` shows that the two draw the
same, and on the card a presampled adagrad run is a replayed CUDA graph.
Left out, as TPU matters: ``unroll='auto'``, the stacking of host fetches
against the TPU's dispatch floor, ``--accel`` and Cloud-TPU discovery.
"""
MODULES = ('normal_mixture', 'robust_regression', 'funnel', 'eight_schools',
           'linear_regression_ia', 'eight_schools_ia', 'chivi_experiments',
           'multistart_pipeline', 'pod_layout', 'large_d')
