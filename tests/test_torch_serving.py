"""Serving with the PyTorch port against the JAX reference: greedy
tokens of the port's ``Engine`` and ``ContinuousEngine`` equal the JAX
``Engine``'s from the same weights (reduced gpt2m, fp32) for both KV
dtypes; the continuous engine equals the port's fixed engine token for
token; the slot steps; and the port's package rules (no JAX, no
``repro`` imports; entry points refuse to run without a card unless
asked for the CPU)."""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousEngine, Engine, Request, ServeStats, SlotScheduler,
    sample_tokens,
)
from repro_torch.serve.steps import (  # noqa: E402
    decode_slots_step, insert_step,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROMPT_LENS = (5, 9, 9, 14)
MAX_NEW = 5


@pytest.fixture(scope="module")
def setup():
    from repro import configs as jconfigs
    from repro.launch.mesh import make_host_mesh
    from repro.models import Model as JModel

    jcfg = dataclasses.replace(jconfigs.get_config("gpt2m").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config("gpt2m").reduced(),
                               dtype="float32")
    jm = JModel(jcfg)
    mesh = make_host_mesh((1, 1), ("data", "model"))
    with jax.set_mesh(mesh):
        jp = jm.init(jax.random.key(0))
    tm = TModel(tcfg, device="cpu")
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(3)
    prompts = [np.asarray(rng.integers(4, 400, (n,)), np.int32)
               for n in PROMPT_LENS]
    return jm, jp, mesh, tm, tp, prompts


def _by_length(prompts):
    groups = {}
    for i, p in enumerate(prompts):
        groups.setdefault(len(p), []).append(i)
    return groups


def _fixed_tokens(make_engine, params, prompts):
    """Greedy tokens per prompt from fixed-batch engines, one per prompt
    length (a batch shares its prompt length)."""
    out = {}
    for n, idxs in _by_length(prompts).items():
        res = make_engine(len(idxs)).generate(
            params, {"tokens": np.stack([prompts[i] for i in idxs])},
            n_tokens=MAX_NEW)
        for row, i in enumerate(idxs):
            out[i] = res["tokens"][row]
    return out


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_engines_match_reference_greedy_tokens(setup, kv_dtype):
    from repro.core.plans import get_plan
    from repro.serve import Engine as JEngine

    jm, jp, mesh, tm, tp, prompts = setup
    ref = _fixed_tokens(
        lambda b: JEngine(jm, get_plan("data"), mesh, batch_size=b,
                          max_len=32, kv_dtype=kv_dtype), jp, prompts)
    fixed = _fixed_tokens(
        lambda b: Engine(tm, batch_size=b, max_len=32, kv_dtype=kv_dtype,
                         device="cpu"), tp, prompts)
    ce = ContinuousEngine(tm, slots=2, max_len=32, buckets=(8, 16),
                          kv_dtype=kv_dtype, device="cpu")
    res = ce.run(tp, [Request(i, p) for i, p in enumerate(prompts)],
                 max_new=MAX_NEW)
    for i in range(len(prompts)):
        np.testing.assert_array_equal(fixed[i], ref[i],
                                      err_msg=f"fixed, request {i}")
        # the port's own contract: continuous == fixed, token for token
        np.testing.assert_array_equal(res["outputs"][i], fixed[i],
                                      err_msg=f"continuous, request {i}")
    st = res["stats"]
    assert st.n_tokens == MAX_NEW * len(prompts)
    assert 0 < st.mean_occupancy <= 2 and len(st.ttft_s) == len(prompts)


def test_decode_slots_freezes_dead_slots_and_insert_rewinds(setup):
    _, _, _, tm, tp, prompts = setup
    cache = tm.init_slot_cache(3, 16, kv_dtype="int8")
    src = tm.init_cache(1, 16, kv_dtype="int8")
    _, src = tm.prefill(tp, {"tokens": np.pad(prompts[0], (0, 3))[None]},
                        src, last_pos=len(prompts[0]) - 1)
    assert src.index.tolist() == [8, 8]          # the padded bucket
    cache = insert_step(cache, src, 1, len(prompts[0]))
    assert cache.index.tolist() == [[0, 5, 0], [0, 5, 0]]
    torch.testing.assert_close(cache.k_q[:, 1], src.k_q[:, 0])
    live = torch.tensor([False, True, False])
    _, tok, cache = decode_slots_step(
        tm, tp, cache, torch.tensor([[0], [7], [0]]), live, pad_id=0)
    assert cache.index.tolist() == [[0, 6, 0], [0, 6, 0]]
    assert tok[0, 0] == 0 and tok[2, 0] == 0


def test_sample_tokens_greedy_and_topk():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0]] * 64)
    assert sample_tokens(logits, None).tolist() == [1] * 64
    g = torch.Generator().manual_seed(0)
    draws = sample_tokens(logits, g, temperature=1.0, top_k=2)
    assert set(draws.tolist()) <= {1, 3} and draws.dtype == torch.int32
    again = sample_tokens(logits, torch.Generator().manual_seed(0),
                          temperature=1.0, top_k=2)
    assert torch.equal(draws, again)


def test_serve_stats_and_scheduler():
    st = ServeStats(decode_s=[0.1, 0.1, 0.1], n_slots=4)
    assert st.tokens_per_s == pytest.approx(40.0)
    s = SlotScheduler(2)
    a = s.admit(10, max_new=1)
    assert s.record_token(a) and s.evict(a) == 10
    with pytest.raises(KeyError):
        s.evict(a)
    s.check()


def test_launch_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve

    res = serve.main(["--reduced", "--device", "cpu", "--continuous",
                      "--batch", "2", "--gen", "3", "--trace", "3x4..9",
                      "--kv-dtype", "int8"])
    assert sorted(res["outputs"]) == [0, 1, 2]
    assert "continuous slots=2" in capsys.readouterr().out


def test_entry_points_need_a_card_unless_asked_for_cpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = tconfigs.get_config("gpt2m").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        TModel(cfg)
    tm = setup[3]
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(tm, batch_size=1, max_len=8)
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousEngine(tm, slots=1, max_len=8)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduced"])


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    scanned = {f.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for f in files[:-1]}
    assert {"data/pipeline.py", "data/tokenizer.py", "data/corpus.py",
            "optim/adamw.py", "optim/schedule.py", "core/steps.py",
            "train/loop.py", "train/checkpoint.py", "train/evaluate.py",
            "launch/train.py", "models/moe.py", "kernels/rmsnorm.py",
            "configs/llama3_2_3b.py", "configs/phi35_moe_42b.py"} <= scanned
    for f in files:
        bad = {r for r in _imported_roots(f)
               if r in ("jax", "jaxlib", "repro", "flax")}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
