"""The port's partition rules, placements and sharded training against the
JAX package: ``tests/test_partition.py``'s classes (the rule matcher,
``DtypePolicy``, shard/gather round trips and loud demotions, every
registered rule set, the partitioned train step on one rank and on 2 x 2,
mesh pretraining, the dp featurizer) and ``tests/test_sharding_analysis
.py``'s cases, its HLO checks as the port's collective counters and
``DTensor`` placements.

The port's side runs in two spawns of gloo ranks on the CPU
(``tests/torch_parallel_ranks.py``): 4 ranks as a dp = 2 x tp = 2 mesh,
and 1 rank. The JAX side runs unsharded on the CPU from the same weights
(converted by the port's converters): the JAX package holds its sharded
step to the unsharded one, and so does this file. Pretraining losses are
held within 1e-4, parameters after a step within 1e-4 relative (atol
1e-6), forward outputs within 1e-5.
"""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmlspark_tpu.dl.bert import BertEncoder as JBertEncoder
from mmlspark_tpu.dl.pretrain import MaskedLMModel as JMaskedLMModel
from mmlspark_tpu.dl.pretrain import pretrain_masked_lm as jpretrain
from mmlspark_tpu.dl.text_encoder import TextEncoder as JTextEncoder
from mmlspark_tpu.dl.train import init_train_state as jinit_train_state
from mmlspark_tpu.dl.train import make_train_step as jmake_train_step
from mmlspark_tpu.dl.train import param_spec as jparam_spec
from mmlspark_tpu.models.resnet import BasicBlock as JBasicBlock
from mmlspark_tpu.models.resnet import ResNet as JResNet
from mmlspark_tpu.models.vit import ViT as JViT
from mmlspark_tpu.parallel import partition as jpartition
from mmlspark_torch.models import LoadedModel, get_model
from mmlspark_torch.models.convert import (bert_encoder_from_flax,
                                           masked_lm_from_flax,
                                           resnet_from_flax,
                                           text_encoder_from_flax,
                                           vit_from_flax)
from mmlspark_torch.obs import registry
from mmlspark_torch.parallel import (DtypePolicy, match_partition_rules,
                                     named_leaves, partition_rules_for,
                                     registered_rule_sets)

from torch_parallel_ranks import spawn

RTOL, ATOL = 1e-4, 1e-6
BERT = dict(vocab=64, width=32, depth=2, heads=2, mlp_dim=64, max_len=32)
TINY = dict(vocab=64, width=16, depth=1, heads=2, mlp_dim=32)
TREE_RULES = [(r"embedding", ("tp", None)), (r"qkv/kernel", (None, "tp")),
              (r"qkv/bias", ("tp",))]


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def init(module, x, *args):
    return np_tree(jax.jit(module.init, static_argnums=tuple(
        range(2, 2 + len(args))))(jax.random.PRNGKey(0), x, *args))


@pytest.fixture(scope="module")
def payload():
    """Weights and inputs both packages see: the JAX inits converted by the
    port's converters."""
    rng = np.random.default_rng(0)
    tree = {"emb": {"embedding": rng.normal(size=(16, 8))
                    .astype(np.float32)},
            "qkv": {"kernel": rng.normal(size=(8, 24)).astype(np.float32),
                    "bias": np.zeros(24, np.float32)},
            "step": np.zeros((), np.int32)}
    jbert = JBertEncoder(**BERT, pooler=False, dtype=jnp.float32)
    ids = rng.integers(1, 64, size=(16, 16)).astype(np.int32)
    labels = rng.integers(0, 32, size=16).astype(np.int32)
    bert_params = init(jbert, jnp.asarray(ids[:1]), True)["params"]
    mlm_ids = np.random.default_rng(0).integers(1, 60, size=(64, 12)) \
        .astype(np.int32)
    jmlm = JMaskedLMModel(JTextEncoder(**TINY, dtype=jnp.float32))
    mlm_params = init(jmlm, jnp.asarray(mlm_ids[:1]), True)["params"]
    jenc = JTextEncoder(**TINY, dtype=jnp.float32)
    feat_rows = [[1, 2, 3], [4, 5], [6], [7, 8, 9], [2]]
    feat_ids = np.zeros((5, 8), np.int32)
    for i, r in enumerate(feat_rows):
        feat_ids[i, :len(r)] = r
    enc_params = init(jenc, jnp.asarray(feat_ids), False)["params"]
    return dict(
        tree=tree, tree_rules=TREE_RULES, ids=ids, labels=labels,
        bert_params=bert_params,
        bert=bert_encoder_from_flax(bert_params, heads=2,
                                    dtype=torch.float32),
        mlm_params=mlm_params, mlm_ids=mlm_ids,
        mlm=masked_lm_from_flax(mlm_params, heads=2, dtype=torch.float32),
        jenc=jenc, enc_params=enc_params, feat_rows=feat_rows,
        feat_ids=feat_ids,
        feat_model=LoadedModel(get_model("TextEncoderBase"),
                               text_encoder_from_flax(
                                   enc_params, heads=2,
                                   dtype=torch.float32)))


def port_payload(payload):
    return {k: v for k, v in payload.items()
            if k not in ("jenc", "bert_params", "mlm_params", "enc_params")}


@pytest.fixture(scope="module")
def ranks(payload):
    """The port's side on a dp = 2 x tp = 2 mesh: one spawn of 4 ranks."""
    return spawn("partition", 4, port_payload(payload))


@pytest.fixture(scope="module")
def one_rank(payload):
    return spawn("one_rank", 1, port_payload(payload))


@pytest.fixture(scope="module")
def jax_bert(payload):
    """The JAX unsharded BERT step (``_bert_fixture``): AdamW losses over 4
    steps, the parameters after one SGD step, and an accumulated step."""
    module = JBertEncoder(**BERT, pooler=False, dtype=jnp.float32)
    ids, labels = jnp.asarray(payload["ids"]), jnp.asarray(payload["labels"])

    def run(tx, steps, accum=1):
        state = jinit_train_state(module, jax.random.PRNGKey(0), ids[:1], tx)
        step = jmake_train_step(module, tx, fetch="pooled", accum_steps=accum)
        losses = []
        for _ in range(steps):
            state, loss = step(state, ids, labels)
            losses.append(float(loss))
        return losses, np_tree(state.params)

    adamw, _ = run(optax.adamw(1e-3), 4)
    _, sgd = run(optax.sgd(1e-2), 1)
    accum, _ = run(optax.adamw(1e-3), 1, accum=2)
    return dict(adamw=adamw, sgd=sgd, accum=accum)


def bert_leaf(params, name):
    """The flax leaf behind a port BERT parameter, in the port's layout."""
    *path, leaf = name.split(".")
    node = params
    for p in path:
        node = node[{"typ": "type", "pooler_dense": "pooler"}.get(p, p)]
    if leaf == "weight":
        key = next(k for k in ("kernel", "scale", "embedding") if k in node)
        x = np.asarray(node[key])
        return x.T if key == "kernel" else x
    return np.asarray(node[leaf])


class TestMatchRules:
    def test_first_match_wins(self):
        params = {"block0": {"q": {"weight": torch.zeros(8, 8)}}}
        rules = [(r"q/weight", ("tp", None)), (r"weight", (None, "tp"))]
        assert match_partition_rules(rules, params)["block0"]["q"][
            "weight"] == ("tp", None)
        assert match_partition_rules(list(reversed(rules)), params)[
            "block0"]["q"]["weight"] == (None, "tp")

    def test_scalars_replicate_and_specs_right_align(self):
        params = {"step": torch.zeros(()), "one": torch.zeros(1),
                  "w": torch.zeros(4, 4), "stacked": torch.zeros(3, 4, 4)}
        rules = [(r".*", ("tp", None))]
        got = match_partition_rules(rules, params)
        want = jpartition.match_partition_rules(rules, {
            k: jnp.zeros(v.shape) for k, v in params.items()})
        for k in params:
            assert got[k] == tuple(want[k]), k
        with pytest.raises(ValueError, match="more entries"):
            match_partition_rules([(r"b", (None, None, "tp"))],
                                  {"b": torch.zeros(4, 4)})

    def test_unmatched_leaf_is_loud(self):
        c = registry.counter("parallel_unmatched_leaves_total")
        before = c.value()
        with pytest.warns(UserWarning, match="mystery"):
            got = match_partition_rules([(r"kernel", ("tp",))],
                                        {"mystery": torch.zeros(4, 4)})
        assert got["mystery"] == () and c.value() == before + 1
        with pytest.raises(ValueError, match="mystery"):
            match_partition_rules([(r"kernel", ("tp",))],
                                  {"mystery": torch.zeros(4, 4)},
                                  on_unmatched="error")

    def test_rule_match_counter(self):
        c = registry.counter("parallel_rule_match_total")
        before = c.value(rule=r"q/weight")
        match_partition_rules([(r"q/weight", ("tp", None))],
                              {"q": {"weight": torch.zeros(4, 4)}})
        assert c.value(rule=r"q/weight") == before + 1

    def test_optimizer_state_paths_match_param_rules(self):
        """The optimizer's moments are named after their parameter, so the
        same rule places them, as optax's nested states are in JAX."""
        from mmlspark_torch.dl import TrainState
        model = torch.nn.Module()
        model.qkv = torch.nn.Linear(8, 24)
        opt = torch.optim.AdamW(model.parameters())
        model.qkv(torch.zeros(1, 8)).sum().backward()
        opt.step()
        specs = match_partition_rules([(r"qkv/weight", ("tp", None)),
                                       (r"qkv/bias", ("tp",))],
                                      TrainState(model, opt))
        assert specs["opt_state/qkv/weight/exp_avg"] == ("tp", None)
        assert specs["opt_state/qkv/weight/exp_avg_sq"] == ("tp", None)
        assert specs["opt_state/qkv/weight/step"] == ()
        jopt = optax.adamw(1e-3).init({"qkv": {"kernel": jnp.zeros((8, 24))}})
        jspecs = dict(jpartition.named_leaves(jpartition.match_partition_rules(
            [(r"qkv/kernel", (None, "tp"))], jopt)))
        mu = [v for k, v in jspecs.items() if "mu" in k]
        assert [tuple(reversed(tuple(m))) for m in mu] == [("tp", None)]


class TestDtypePolicy:
    def test_casts_float_leaves_only_as_jax(self):
        for policy_kw, tree in (
                (dict(param_dtype="bfloat16"),
                 {"w": np.zeros(4, np.float32), "ids": np.zeros(4, np.int32),
                  "flag": np.zeros(4, bool)}),
                (dict(param_dtype=None), {"w": np.zeros(4, np.float16)}),
                (dict(grad_accum_dtype="float32"),
                 {"g": np.zeros(4, np.float16)})):
            ours, theirs = DtypePolicy(**policy_kw), \
                jpartition.DtypePolicy(**policy_kw)
            for cast in ("cast_params", "cast_grad_accum", "cast_compute"):
                got = getattr(ours, cast)({k: torch.from_numpy(v)
                                           for k, v in tree.items()})
                want = getattr(theirs, cast)(tree)
                for k in tree:
                    assert str(got[k].dtype)[6:] == str(want[k].dtype), \
                        (cast, k)


class TestShardGather:
    def test_2x2_round_trip(self, ranks, payload):
        assert ranks["tree_specs"] == {"qkv": (None, "tp"),
                                       "emb": ("tp", None)}
        assert ranks["tree_local"] == (8, 12)          # 24 over tp = 2
        back = ranks["tree_back"]
        for (name, a), (_, b) in zip(
                jpartition.named_leaves(payload["tree"]),
                jpartition.named_leaves(back)):
            np.testing.assert_array_equal(a, b, err_msg=name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, name

    def test_demotions_are_loud(self, ranks):
        d = ranks["demote"]
        spec, counted, shape = d["non_divisible"]
        assert spec == (None, None) and counted == 1 and shape == (9, 8)
        spec, counted, value = d["missing_axis"]
        assert spec == (None, None) and counted == 1
        np.testing.assert_array_equal(value, np.ones((8, 8)))
        assert d["warned"] == 2
        assert d["short_spec"] == (None, "tp")
        assert "more entries" in d["long_spec"]
        assert d["policy_dtypes"] == ("torch.bfloat16", "torch.int32")


def varying_dims(a) -> set:
    a = np.asarray(a, np.float64)
    return {d for d in range(a.ndim)
            if a.shape[d] > 1 and not np.all(np.diff(a, axis=d) == 0)}


def marked(jax_tree, rules):
    """Each leaf of a flax tree as arange along its tp-sharded dim under
    the JAX rules (a constant when replicated), and the JAX specs."""
    specs = dict(jpartition.named_leaves(jpartition.match_partition_rules(
        rules, jax_tree, on_unmatched="error", _count=False)))

    def mark(path, leaf):
        name = "/".join(jpartition._key_str(k) for k in path)
        spec = tuple(specs[name])
        a = np.full(np.shape(leaf), 0.5, np.float32)
        if "tp" in spec:
            d = spec.index("tp")
            shape = [1] * a.ndim
            shape[d] = a.shape[d]
            a = a + np.arange(a.shape[d], dtype=np.float32).reshape(shape)
        return a
    return jax.tree_util.tree_map_with_path(mark, jax_tree)


class TestModelRuleSets:
    """Every registered port model's whole parameter tree matches with no
    unmatched leaf and at least one tp-sharded weight; through the port's
    converter, each weight's tp dim is the one the JAX rule shards in the
    flax leaf it comes from."""

    def test_registry_equals_the_jax_packages(self):
        import mmlspark_tpu.dl.bert             # noqa: F401
        import mmlspark_tpu.dl.pretrain         # noqa: F401
        import mmlspark_tpu.models.resnet       # noqa: F401
        import mmlspark_tpu.models.vit          # noqa: F401
        import mmlspark_torch.dl.bert           # noqa: F401
        import mmlspark_torch.dl.pretrain       # noqa: F401
        import mmlspark_torch.models.resnet     # noqa: F401
        import mmlspark_torch.models.vit        # noqa: F401
        assert registered_rule_sets() == jpartition.registered_rule_sets()
        for name in registered_rule_sets():
            ours = partition_rules_for(name)
            assert len(ours) == len(jpartition.partition_rules_for(name))
            from mmlspark_torch.parallel import (activation_spec_for,
                                                 dtype_policy_for)
            assert activation_spec_for(name) == \
                jpartition.activation_spec_for(name)
            assert dtype_policy_for(name).__dict__ == \
                jpartition.dtype_policy_for(name).__dict__

    @pytest.mark.parametrize("name", ["ResNet", "ViT", "BertEncoder",
                                      "TextEncoder", "TextEncoderLM"])
    def test_rule_set_layout_through_the_converter(self, name):
        x_img = jnp.zeros((1, 32, 32, 3))
        ids = jnp.zeros((1, 8), jnp.int32)
        if name == "ResNet":
            variables = init(JResNet(stage_sizes=(1, 1), block=JBasicBlock,
                                     num_classes=8, width=8), x_img, False)
            convert = lambda v: resnet_from_flax(v, dtype=torch.float32)
        elif name == "ViT":
            variables = init(JViT(patch=8, width=32, depth=1, heads=2,
                                  mlp_dim=64, num_classes=8), x_img, False)
            convert = lambda v: vit_from_flax(v, heads=2,
                                              dtype=torch.float32)
        elif name == "BertEncoder":
            variables = init(JBertEncoder(vocab=64, width=16, depth=1,
                                          heads=2, mlp_dim=32, max_len=16),
                             ids)
            convert = lambda v: bert_encoder_from_flax(v, heads=2)
        elif name == "TextEncoder":
            variables = init(JTextEncoder(**TINY), ids, False)
            convert = lambda v: text_encoder_from_flax(
                v, heads=2, dtype=torch.float32)
        else:
            variables = init(JMaskedLMModel(JTextEncoder(**TINY)), ids)
            convert = lambda v: masked_lm_from_flax(v, heads=2,
                                                    dtype=torch.float32)
        jrules = jpartition.partition_rules_for(name)
        marks = {c: marked(tree, jrules) for c, tree in variables.items()}
        module = convert(marks)
        specs = match_partition_rules(partition_rules_for(name), module,
                                      on_unmatched="error")
        assert any("tp" in s for s in specs.values()), name
        for path, t in named_leaves(module):
            want = {d for d, e in enumerate(specs[path]) if e == "tp"}
            assert varying_dims(t.detach()) == want, (name, path,
                                                      specs[path])


class TestPartitionedTrainStep:
    def test_one_rank_matches_jax(self, one_rank, jax_bert, payload):
        """On a one-rank mesh the partitioned step's AdamW trajectory is
        the JAX unsharded step's, and one SGD step's parameters too."""
        np.testing.assert_allclose(one_rank["adamw"]["losses"],
                                   jax_bert["adamw"], rtol=1e-4)
        for n, got in one_rank["sgd"]["params"].items():
            np.testing.assert_allclose(got, bert_leaf(jax_bert["sgd"], n),
                                       rtol=RTOL, atol=ATOL, err_msg=n)

    def test_2x2_matches_jax_and_keeps_its_layout(self, ranks, jax_bert):
        got = ranks["bert_2x2"]
        np.testing.assert_allclose(got["losses"], jax_bert["adamw"][:3],
                                   rtol=1e-4)
        # the q weight stays column-parallel: Shard(0) on tp, its block
        assert got["q_placement"] == ["Replicate()", "Replicate()",
                                      "Replicate()", "Replicate()",
                                      "Shard(dim=0)"]
        assert got["q_local"] == (16, 32)
        for n, p in ranks["bert_2x2_sgd"]["params"].items():
            np.testing.assert_allclose(p, bert_leaf(jax_bert["sgd"], n),
                                       rtol=RTOL, atol=ATOL, err_msg=n)

    def test_accum_steps_with_grad_accum_dtype(self, ranks, jax_bert):
        np.testing.assert_allclose(ranks["bert_accum_f32"],
                                   jax_bert["accum"], rtol=1e-4)
        # a lower-precision accumulator than the gradients: still finite
        assert np.isfinite(ranks["bert_accum_bf16"]).all()


class TestMeshPretrain:
    def test_masked_lm_mesh_matches_jax(self, ranks, payload):
        _, want = jpretrain(JTextEncoder(**TINY, dtype=jnp.float32),
                            payload["mlm_ids"], steps=3, batch_size=8)
        np.testing.assert_allclose(ranks["mlm_losses"], want, rtol=1e-4)

    def test_batch_must_divide_dp_and_dp_is_needed(self, ranks):
        divide, no_dp = ranks["mlm_errors"]
        assert "divide" in divide
        assert "'dp'" in no_dp


class TestFeaturizerDpSharding:
    def test_dp_mesh_embeds_and_unpads(self, ranks, payload):
        """5 rows over dp = 4 (3 padding rows): 5 rows back, each the JAX
        encoder's row."""
        feats = ranks["featurizer"]
        assert feats.shape == (5, 16)
        want = payload["jenc"].apply({"params": payload["enc_params"]},
                                     jnp.asarray(payload["feat_ids"]),
                                     False)["pooled"]
        np.testing.assert_allclose(feats, np.asarray(want), atol=1e-5)


class TestShardingAnalysis:
    """``test_sharding_analysis.py``'s checks on the port: placements and
    collective counts in place of HLO text."""

    def test_large_kernels_are_tp_sharded_as_jax(self, ranks):
        """The heuristic shards what the JAX one does (its flax kernels'
        output dim, the port weights' dim 0); scales and biases
        replicate."""
        res = ranks["resnet"]
        sharded = {n for n, (spec, _) in res["before"].items()
                   if "tp" in spec}
        assert sharded and any("head" in n or "Conv" in n for n in sharded)
        for n, (spec, _) in res["before"].items():
            if n.endswith(("scale", "bias")):
                assert "tp" not in spec, n
        variables = init(JResNet(stage_sizes=(1, 1), block=JBasicBlock,
                                 width=64, num_classes=128,
                                 dtype=jnp.float32),
                         jnp.zeros((1, 16, 16, 3)), False)
        jsharded = set()
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                variables["params"]):
            name = "/".join(jpartition._key_str(k) for k in path)
            if "tp" in tuple(jparam_spec(path, jnp.asarray(leaf), 2)):
                jsharded.add("params/" + name.replace("kernel", "weight"))
        assert sharded == jsharded

    def test_step_all_reduces_and_keeps_placements(self, ranks):
        res = ranks["resnet"]
        assert np.isfinite(res["loss"])
        assert res["allreduce_calls"] > 0      # the dp gradient sum
        assert res["after"] == res["before"] and res["shapes_ok"]

    def test_grad_accum_keeps_batch_sharded(self, ranks):
        """accum_steps=2 over dp = 4 on 32 rows: each microbatch's forward
        sees its 4 rows, and the step gathers no batch."""
        acc = ranks["accum_rows"]
        assert acc["rows"] == [4, 4]
        assert not any("allgather" in k for k in acc["moved"])

    def test_gbdt_grower_all_reduces_its_histograms(self, ranks):
        calls, moved = ranks["gbdt"]
        assert calls > 0
        assert any("allreduce_sum" in k and "calls" in k for k in moved)


def test_rules_name_every_port_parameter_once():
    """No rule set leaves a port parameter to the loud fallback (the
    acceptance bar the JAX package's per-model tests set)."""
    from mmlspark_torch.dl import MaskedLMModel, TextEncoder
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        match_partition_rules(partition_rules_for("TextEncoderLM"),
                              MaskedLMModel(copy.deepcopy(TextEncoder(
                                  **TINY))), on_unmatched="error")
