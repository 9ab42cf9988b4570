"""Data-parallel classifier training and evaluation in the PyTorch port
(``train/classifier.py``, ``infer/evaluate.py``, the global-batch ``batch_norm_train``)
against the JAX package's mesh runs on its 8 fake CPU devices, over 2 gloo ranks on
the CPU (``parallel.launch``). Tolerances:

- ``train_classifier(mesh=)``: the configuration of
  ``tests/test_torch_train_artist_classifier.py``'s trajectory test (lr 1e-5, 3
  epochs) and its bars against JAX's 2-device mesh and single-device runs and the
  port's single process: ``train_loss`` within rtol 1e-3, the accuracies equal, the BN
  running statistics (the global batch's) within 1e-3 of their magnitude. JAX's mesh
  bar, rtol 1e-4 against its own single device, is not the port's: this train-mode
  ResNet-50 amplifies the f32 rounding of any other BN arithmetic, and the port's
  single process is 1.1e-4 of the first loss from a world of one over gloo (measured;
  the BN itself is held at 1e-5 in ``tests/test_torch_distributed.py``);
- ``evaluate_with_classifier(mesh=)``, f32 and int8: ``Acc=`` and every ``Pred=``
  line equal to JAX's mesh run.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from artist_style_transfer_tpu.parallel import make_mesh as jmake_mesh
from artist_style_transfer_tpu.train.loop import epoch_permutation as jepoch_permutation
from artist_style_transfer_tpu_torch.models.transformer import TransformerNet
from artist_style_transfer_tpu_torch.parallel import launch, workers
from artist_style_transfer_tpu_torch.utils.jax_params import transformer_state_dict_from_jax
from tests.test_torch_data import one_torch_thread  # noqa: F401


# --- train_classifier(mesh=) -------------------------------------------------------------


def _classifier_rank(mesh, images, labels, kw, perms):
    """``train_classifier`` on this rank over JAX's permutations (the port's own shuffle is
    a seeded torch one)."""
    from artist_style_transfer_tpu_torch.train import classifier as tclassifier

    tclassifier.epoch_permutation = lambda seed, epoch, n: torch.from_numpy(perms[epoch])
    return workers.train_classifier_rank(mesh, images, labels, kw)


def test_train_classifier_over_two_ranks_matches_jax_mesh():
    """The config of ``tests/test_torch_train_artist_classifier.py``'s trajectory test (lr
    1e-5, 3 epochs, B=8) over 2 ranks of 4 images: the loss against JAX's 2-device mesh,
    JAX's single device and the port's single process within rtol 1e-3, the accuracies
    equal, the BN running statistics (the global batch's) within 1e-3 of their magnitude,
    the ranks bit-identical."""
    import functools

    from artist_style_transfer_tpu.models import resnet as jresnet
    from artist_style_transfer_tpu.train import classifier as jclassifier
    from artist_style_transfer_tpu_torch.utils.jax_params import classifier_state_dict_to_jax
    from tests.test_torch_classifier import numpy_params
    from tests.test_torch_train_artist_classifier import port_classifier, separable_data

    images, labels = separable_data()
    params = numpy_params(functools.partial(jresnet.init_classifier_params, num_classes=3), 0)
    kw = dict(num_classes=3, num_epochs=3, batch_size=8, lr=1e-5, freeze_body=True,
              val_fraction=0.25, seed=2, wordy=False)
    perms = [np.array(jepoch_permutation(2, e, 18)) for e in range(3)]
    ranks = launch(_classifier_rank, 2, images, labels, dict(kw, model=port_classifier(params)),
                   perms, backend="gloo", device="cpu")
    single = launch(_classifier_rank, 1, images, labels, dict(kw, model=port_classifier(params)),
                    perms, backend="gloo", device="cpu")[0]
    for k, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][k], v, err_msg=k)
    got = ranks[0]
    ours = classifier_state_dict_to_jax({k: torch.from_numpy(v) for k, v in got["params"].items()})
    for name, mesh in (("mesh", jmake_mesh(shape=(2,))), ("single", None)):
        best, hist = jclassifier.train_classifier(images, labels, mesh=mesh,
                                                  params=jax.tree.map(jnp.asarray, params), **kw)
        np.testing.assert_allclose(got["history"]["train_loss"], hist["train_loss"], rtol=1e-3,
                                   err_msg=name)
        assert got["history"]["train_acc"] == hist["train_acc"], name
        assert got["history"]["val_acc"] == hist["val_acc"], name
        ref = jax.tree.map(np.asarray, best)
        for part in (("stem", "bn"), ("head", "bn1"), ("head", "bn2")):
            a, b = ours[part[0]][part[1]], ref[part[0]][part[1]]
            for stat in ("mean", "var"):
                assert np.abs(a[stat] - b[stat]).max() <= 1e-3 * np.abs(b[stat]).max(), (name, part)
    np.testing.assert_allclose(got["history"]["train_loss"], single["history"]["train_loss"],
                               rtol=1e-3)
    for k in ("0.1.running_mean", "0.1.running_var", "1.2.running_mean", "1.6.running_var"):
        want = single["params"][k]
        assert np.abs(got["params"][k] - want).max() <= 1e-3 * np.abs(want).max(), k


# --- evaluate_with_classifier(mesh=) ------------------------------------------------------


def test_evaluate_with_classifier_over_two_ranks_matches_jax_mesh(capsys):
    """f32 (a random classifier, mixed sizes, a padded last batch of a size) and int8 (a
    decisive classifier): rank 0 prints JAX's mesh run's ``Pred=`` and ``Acc=`` lines,
    rank 1 nothing, and both return its accuracy."""
    from artist_style_transfer_tpu.infer.evaluate import evaluate_with_classifier as jax_eval
    from artist_style_transfer_tpu.models.transformer import init_transformer_params as jinit
    from artist_style_transfer_tpu_torch.models.resnet import ARTISTS_19
    from artist_style_transfer_tpu_torch.utils.jax_params import (
        classifier_state_dict_to_jax,
        transformer_state_dict_to_jax,
    )
    from tests.test_torch_classifier import (
        CROP,
        EVAL_SHAPES,
        jax_classifier_params,
        numpy_params,
        port_classifier,
    )
    from tests.test_torch_int8 import decisive_pair

    tparams, cparams = numpy_params(jinit, 4), jax_classifier_params(3)
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in EVAL_SHAPES]
    model = TransformerNet()
    model.load_state_dict(transformer_state_dict_from_jax(tparams))
    qmodel, qclf = decisive_pair()
    q_images = (rng.random((4, 64, 64, 3)) * 255).astype(np.float32)
    kw = dict(batch_size=2, artists=ARTISTS_19, crop_size=CROP)
    jobs = [(workers.evaluate_rank, (model, port_classifier(cparams), images, 7, kw), {}),
            (workers.evaluate_rank, (qmodel, qclf, q_images, 7, dict(kw, quantize=True)), {})]
    ranks = launch(workers.run_jobs, 2, jobs, backend="gloo", device="cpu")
    jruns = [(tparams, cparams, [im.astype(np.float32) for im in images]),
             ({k: v for k, v in transformer_state_dict_to_jax(qmodel.state_dict()).items()},
              classifier_state_dict_to_jax(qclf.state_dict()), q_images)]
    for i, (tp, cp, ims) in enumerate(jruns):
        capsys.readouterr()
        acc = jax_eval(jax.tree.map(jnp.asarray, tp), jax.tree.map(jnp.asarray, cp), ims, 7,
                       mesh=jmake_mesh(shape=(2,)), quantize=i == 1, **kw)
        want = capsys.readouterr().out
        assert ranks[0][i]["acc"] == ranks[1][i]["acc"] == acc
        assert ranks[0][i]["stdout"] == want and want.endswith(f"Acc={acc}\n")
        assert ranks[1][i]["stdout"] == ""
    assert ranks[0][1]["acc"] == 100.0  # the decisive classifier names its artist
