"""The PyTorch port's training loop and its I/O against the JAX
reference, on the CPU: the data pipeline (copied numpy code), the
reference's double label shift, four steps of ``train()`` (also with
gradient accumulation), checkpoints written by either package and
restored by the other, evaluation, and the launcher.

Tolerances and why:

* data and checkpoints: the same numpy code and the same npz files, so
  arrays are equal, bit for bit.
* the training run, fp32 on a reduced gpt2m: per step, loss and
  gradients agree to ~1e-6 relative (other summation orders); AdamW
  then moves params by ~lr, so four steps' losses agree to ~1e-6
  relative.  ``TRAIN_RTOL`` is 1e-4.
* evaluation, fp32: the loss of each batch agrees to ~1e-7 relative;
  ``EVAL_RTOL`` 1e-5.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core.plans import get_plan  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models.model import lm_loss as jlm_loss  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import evaluate as jeval  # noqa: E402
from repro.train import train as jtrain  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models.model import lm_loss as tlm_loss  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import evaluate as teval  # noqa: E402
from repro_torch.train import train as ttrain  # noqa: E402

TRAIN_RTOL = 1e-4
EVAL_RTOL = 1e-5
SEQ, BATCH = 32, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tensors here are small, and the suite runs several workers on
    a few cores: PyTorch's intra-op threads would contend for them far
    longer than the work takes.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    """(texts, reference tokenizer/dataset, port tokenizer/dataset)."""
    texts = list(jdata.synthetic_wikipedia(60, seed=1))
    jtok = jdata.Tokenizer.train(texts, 512)
    ttok = tdata.Tokenizer.train(texts, 512)
    return (texts, jtok, jdata.build_dataset(texts, jtok, SEQ), ttok,
            tdata.build_dataset(texts, ttok, SEQ))


@pytest.fixture(scope="module")
def pair(corpus):
    """Reduced gpt2m in fp32 at the corpus's vocab: (JAX model, JAX
    params as numpy, port model)."""
    vocab = corpus[1].vocab_size
    jcfg = dataclasses.replace(jconfigs.get_config("gpt2m").reduced(),
                               dtype="float32", vocab_size=vocab)
    tcfg = dataclasses.replace(tconfigs.get_config("gpt2m").reduced(),
                               dtype="float32", vocab_size=vocab)
    jm = JModel(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    return jm, jp, TModel(tcfg, device="cpu")


# ------------------------------------------------------------------ #
# data

def test_corpus_tokenizer_and_dataset_equal_reference(corpus, tmp_path):
    texts, jtok, jds, ttok, tds = corpus
    assert texts == list(tdata.synthetic_wikipedia(60, seed=1))
    assert ttok.words == jtok.words and ttok.vocab_size == jtok.vocab_size
    assert ttok.encode(texts[3]) == jtok.encode(texts[3])
    assert ttok.decode(ttok.encode(texts[3])) == jtok.decode(
        jtok.encode(texts[3]))
    np.testing.assert_array_equal(tds.examples, jds.examples)
    for i, t in enumerate(texts[:3]):
        (tmp_path / f"{i}.txt").write_text(t)
    assert list(tdata.load_text_dir(str(tmp_path))) == \
        list(jdata.load_text_dir(str(tmp_path)))


@pytest.mark.parametrize("n_shards", [1, 2])
def test_loader_batches_equal_reference(corpus, n_shards):
    _, _, jds, _, tds = corpus
    for shard in range(n_shards):
        jl = jdata.Loader(jds, BATCH, seed=3, shard=shard, n_shards=n_shards)
        tl = tdata.Loader(tds, BATCH, seed=3, shard=shard, n_shards=n_shards)
        assert tl.batches_per_epoch == jl.batches_per_epoch
        # steps across the epoch boundary
        for step in (0, 1, jl.batches_per_epoch, jl.batches_per_epoch + 1):
            jb, tb = jl.batch_at(step), tl.batch_at(step)
            assert sorted(tb) == sorted(jb)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k])
                assert tb[k].dtype == jb[k].dtype


def test_loader_labels_are_scored_two_tokens_ahead(corpus):
    """The reference shifts twice: the Loader's labels are already the
    next token, and ``lm_loss`` shifts again, so position i is scored
    against ``window[i + 2]``.  Logits peaked on that token score every
    unmasked position right in both packages; logits peaked on the next
    token (``window[i + 1]``) score almost none."""
    _, jtok, jds, _, _ = corpus
    batch = jdata.Loader(jds, BATCH, seed=0).batch_at(0)
    tokens, labels = batch["tokens"], batch["labels"]
    V = jtok.vocab_size
    B, S = tokens.shape
    plus2 = np.zeros((B, S, V), np.float32)
    plus1 = np.zeros((B, S, V), np.float32)
    rows = np.arange(B)[:, None]
    pos = np.arange(S - 2)[None, :]
    plus2[rows, pos, tokens[:, 2:]] = 10.0        # window[i + 2]
    plus1[rows, np.arange(S - 1)[None], tokens[:, 1:]] = 10.0
    jcfg = jconfigs.get_config("gpt2m").reduced()
    tcfg = tconfigs.get_config("gpt2m").reduced()
    zero = np.float32(0)
    for logits, want in ((plus2, 1.0), (plus1, None)):
        _, jm = jlm_loss(jcfg, jnp.asarray(logits), batch, jnp.asarray(zero))
        _, tm = tlm_loss(tcfg, torch.from_numpy(logits), batch,
                         torch.tensor(zero))
        acc_j, acc_t = float(jm["accuracy"]), float(tm["accuracy"])
        assert acc_t == pytest.approx(acc_j, abs=1e-6)
        if want is not None:
            # the last position's label lies past the window's end
            assert acc_t >= 1.0 - 1.0 / (S - 1) - 1e-6
        else:
            assert acc_t < 0.2
    assert float(tm["tokens"]) == float((labels[:, 1:] >= 0).sum())


# ------------------------------------------------------------------ #
# training

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_losses_match_reference(corpus, pair, grad_accum):
    _, _, jds, _, tds = corpus
    jm, jp, tm = pair
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=4,
              grad_accum=grad_accum)
    mesh = make_host_mesh((1, 1), ("data", "model"))
    jres = jtrain(jm, get_plan("data"), mesh, JTrainConfig(**kw),
                  jdata.Loader(jds, BATCH, seed=0), steps=4,
                  params=jax.tree.map(jnp.asarray, jp), log_every=0)
    tres = ttrain(tm, TrainConfig(**kw), tdata.Loader(tds, BATCH, seed=0),
                  steps=4, params=convert.params_from_numpy(jp),
                  log_every=0)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=TRAIN_RTOL)
    assert tres.losses[-1] < tres.losses[0]
    for key in ("ce", "zloss", "accuracy", "tokens", "grad_norm", "lr"):
        np.testing.assert_allclose(tres.metrics_last[key],
                                   jres.metrics_last[key], rtol=TRAIN_RTOL,
                                   err_msg=key)
    assert len(tres.step_times) == 4
    assert tres.avg_step_time == pytest.approx(np.mean(tres.step_times[1:]))


def test_train_refuses_plans(pair, corpus):
    """Every plan of ``PLANS`` runs (tests/test_torch_plans.py,
    tests/test_torch_plan_families.py); ``train`` refuses one without
    its mesh before any step."""
    from repro_torch.core.plans import PLANS
    _, _, tm = pair
    for plan in PLANS:
        with pytest.raises(ValueError, match="needs a mesh"):
            ttrain(tm, TrainConfig(), tdata.Loader(corpus[4], BATCH),
                   steps=1, plan=plan)


def test_train_resume_and_failure_hook(corpus, pair, tmp_path):
    """Checkpoint every 2 steps, restore step 2 and rerun steps 2..3 from
    ``start_step``: the same losses; a raising hook leaves the partial
    result on the exception."""
    _, _, _, _, tds = corpus
    _, jp, tm = pair
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=4)
    loader = tdata.Loader(tds, BATCH, seed=0)
    full = ttrain(tm, tcfg, loader, steps=4,
                  params=convert.params_from_numpy(jp), log_every=0,
                  ckpt_dir=str(tmp_path), ckpt_every=2)
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith("step_00000004")
    like = convert.params_from_numpy(jp)
    params, opt, step = tckpt.restore_checkpoint(
        str(tmp_path / "step_00000002"), like, toptim.init_adamw(like))
    assert step == 2 and int(opt.step) == 2
    again = ttrain(tm, tcfg, loader, steps=4, params=params, opt_state=opt,
                   start_step=2, log_every=0)
    assert again.losses == full.losses[2:]

    def kill(i):
        if i == 1:
            raise RuntimeError("site lost")
    with pytest.raises(RuntimeError, match="site lost") as info:
        ttrain(tm, tcfg, loader, steps=4, params=params, log_every=0,
               on_step_failure=kill)
    assert len(info.value.result.losses) == 1


# ------------------------------------------------------------------ #
# checkpoints

def _opt_state(params_np, rng):
    m = jax.tree.map(lambda p: rng.standard_normal(p.shape)
                     .astype(np.float32), params_np)
    v = jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32),
                     params_np)
    return m, v


def test_checkpoints_cross_restore_bit_equal(pair, tmp_path):
    _, jp, _ = pair
    m, v = _opt_state(jp, np.random.default_rng(5))
    jopt = joptim.AdamWState(step=jnp.asarray(7, jnp.int32),
                             m=jax.tree.map(jnp.asarray, m),
                             v=jax.tree.map(jnp.asarray, v))
    topt = toptim.AdamWState(step=torch.tensor(7, dtype=torch.int32),
                             m=convert.params_from_numpy(m),
                             v=convert.params_from_numpy(v))
    tparams = convert.params_from_numpy(jp)
    jtempl = (jax.tree.map(jnp.zeros_like, jp),
              joptim.init_adamw(jax.tree.map(jnp.asarray, jp)))
    ttempl = (convert.params_from_numpy(jp), toptim.init_adamw(tparams))

    def check(got_params, got_opt, step):
        assert step == 7 and int(got_opt.step) == 7
        want = {"params": jp, "m": m, "v": v}
        got = {"params": got_params, "m": got_opt.m, "v": got_opt.v}
        for name in want:
            wf = convert.flatten(want[name])
            gf = {k: np.asarray(t) for k, t in
                  convert.flatten(got[name]).items()}
            assert sorted(gf) == sorted(wf)
            for k in wf:
                np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)
                assert gf[k].dtype == wf[k].dtype

    # written by the port, restored by the reference
    tpath = tckpt.save_checkpoint(str(tmp_path / "t"), 7, tparams, topt)
    check(*jckpt.restore_checkpoint(tpath, *jtempl))
    # written by the reference, restored by the port
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 7,
                                  jax.tree.map(jnp.asarray, jp), jopt)
    check(*tckpt.restore_checkpoint(jpath, *ttempl))
    # the same shards, holding the same keys
    assert sorted(os.listdir(tpath)) == sorted(os.listdir(jpath))
    for f in os.listdir(jpath):
        if f.endswith(".npz"):
            with np.load(os.path.join(tpath, f)) as a, \
                    np.load(os.path.join(jpath, f)) as b:
                assert sorted(a.files) == sorted(b.files), f


def test_checkpoint_integrity_and_staging(pair, tmp_path):
    _, jp, _ = pair
    params = convert.params_from_numpy(jp)
    ckpt_dir = str(tmp_path)
    path = tckpt.save_checkpoint(ckpt_dir, 3, params)
    # a staging directory and a manifest-less one are never resumed from
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000008")
    assert tckpt.latest_checkpoint(ckpt_dir) == path
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None
    # dtype change refused unless asked for
    like64 = convert.unflatten({k: t.double() for k, t in
                                convert.flatten(params).items()})
    with pytest.raises(ValueError, match="allow_cast"):
        tckpt.restore_checkpoint(path, like64)
    got, opt, _ = tckpt.restore_checkpoint(path, like64, allow_cast=True)
    assert opt is None and got["embed"]["table"].dtype == torch.float64
    # a truncated shard fails its checksum, in the restore and in convert
    shard = tmp_path / "step_00000003" / "params_01.npz"
    shard.write_bytes(shard.read_bytes()[:-9])
    with pytest.raises(ValueError, match="sha256"):
        tckpt.restore_checkpoint(path, params)
    with pytest.raises(ValueError, match="sha256"):
        convert.load_checkpoint(path)
    with pytest.raises(ValueError, match="manifest"):
        tckpt.verify_checkpoint(str(tmp_path / "step_00000008"))


# ------------------------------------------------------------------ #
# evaluation and the launcher

def test_evaluate_and_embed_match_reference(corpus, pair):
    _, _, jds, _, tds = corpus
    jm, jp, tm = pair
    want = jeval.evaluate_perplexity(jm, jax.tree.map(jnp.asarray, jp),
                                     jdata.Loader(jds, BATCH, seed=0),
                                     max_batches=2)
    params = convert.params_from_numpy(jp)
    got = teval.evaluate_perplexity(tm, params,
                                    tdata.Loader(tds, BATCH, seed=0),
                                    max_batches=2)
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=EVAL_RTOL)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=EVAL_RTOL)
    toks = [tds.examples[:3, :16], tds.examples[3:5, :16]]
    np.testing.assert_allclose(
        teval.embed_texts(tm, params, toks),
        jeval.embed_texts(jm, jax.tree.map(jnp.asarray, jp),
                          [t.astype(np.int32) for t in toks]), atol=1e-5)


def test_launcher_trains_on_cpu(subproc_env):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "gpt2m",
         "--reduced", "--device", "cpu", "--steps", "3", "--seq", "32",
         "--batch", "4", "--docs", "60"],
        capture_output=True, text=True, timeout=300, env=subproc_env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done: loss" in out.stdout


def test_launcher_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.launch import train as launch_train
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--reduced", "--docs", "20", "--steps", "1",
                           "--seq", "16", "--batch", "2"])
