"""The port reads the JAX package's checkpoints without flax or msgpack.

``nnuzoo_tpu_torch.utilities.flax_msgpack.msgpack_restore`` is held to
``flax.serialization`` on what ``to_bytes`` writes: M2NetP's parameter tree,
arrays of every dtype, numpy scalars, arrays that flax splits into chunks
(``MAX_CHUNK_SIZE`` made small) and each msgpack type code. A trained-model
folder in the JAX ``Trainer``'s checkpoint schema (two folds) loads in the
port's ``Predictor``, whose logits agree with the JAX ``Predictor``'s on the
same weights to 1e-3 of their range and whose segmentation is identical.
"""

import pickle

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import flax.serialization as fser  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from nnuzoo_tpu.inference.predictor import Predictor as JaxPredictor  # noqa: E402
from nnuzoo_tpu.models.m2net import M2NetP as JaxM2NetP  # noqa: E402
from nnuzoo_tpu.plans.plans_handler import PlansManager as JaxPlans  # noqa: E402
from nnuzoo_tpu_torch.convert import convert_params, flatten_params  # noqa: E402
from nnuzoo_tpu_torch.inference.predictor import Predictor  # noqa: E402
from nnuzoo_tpu_torch.models import m2net as tm2net  # noqa: E402
from nnuzoo_tpu_torch.models import registry  # noqa: E402
from nnuzoo_tpu_torch.models.m2net import M2NetP  # noqa: E402
from nnuzoo_tpu_torch.utilities.flax_msgpack import msgpack_restore  # noqa: E402

from .test_torch_predictor import DATASET, PATCH, PLANS, PROPS, STAGES  # noqa: E402
from .torch_port_helpers import random_flax_params  # noqa: E402

NAME = "nnUNetTrainerM2NetP"


def _flax_params(seed, deep_supervision=True):
    model = JaxM2NetP(num_classes=3, deep_supervision=deep_supervision,
                      stage_layers=STAGES)
    return random_flax_params(model, jnp.zeros((1, *PATCH, 1)), seed=seed,
                              train=False)


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want), (path, type(got), type(want))
        assert got == want or (got != got and want != want), (path, got, want)


def test_m2netp_params_decode_to_identical_arrays():
    params = jax.tree_util.tree_map(np.asarray, _flax_params(seed=0))
    blob = fser.to_bytes(params)
    got = msgpack_restore(blob)
    _assert_trees_equal(got, fser.msgpack_restore(blob))
    flat_got, flat_want = flatten_params(got), flatten_params(params)
    assert sorted(flat_got) == sorted(flat_want) and len(flat_got) > 100
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], v, err_msg=k)
        assert flat_got[k].flags.writeable, k
    model = M2NetP(1, 3, deep_supervision=False, stage_layers=STAGES)
    a, b = convert_params(got, model), convert_params(params, model)
    assert all(torch.equal(a[k], b[k]) for k in b)


def test_chunked_arrays_and_scalars(monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(1)
    tree = {"big": rng.randn(7, 11).astype(np.float32),       # 308 bytes: 5 chunks
            "nested": {"w": rng.randn(3, 40).astype(np.float64),
                       "small": np.arange(4, dtype=np.int32)},
            "step": np.int32(17), "lr": np.float32(3e-4), "flag": np.bool_(True)}
    blob = fser.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in blob
    got = msgpack_restore(blob)
    _assert_trees_equal(got, fser.msgpack_restore(blob))
    np.testing.assert_array_equal(got["big"], tree["big"])
    assert type(got["step"]) is np.int32 and got["step"] == 17
    assert type(got["lr"]) is np.float32 and got["lr"] == np.float32(3e-4)


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16", "int8", "int16",
                                   "int32", "int64", "uint8", "uint16", "uint32",
                                   "bool"])
def test_array_dtypes(dtype):
    rng = np.random.RandomState(2)
    arr = (rng.randn(3, 5, 2) * 50).astype(dtype)
    blob = fser.to_bytes({"a": arr, "s": arr.reshape(-1)[3], "e": arr[:0]})
    got = msgpack_restore(blob)
    _assert_trees_equal(got, fser.msgpack_restore(blob))


_VALUES = {
    "nil_and_bools": [None, True, False],
    "fixints": [0, 1, 127, -1, -32],
    "unsigned": [128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1],
    "signed": [-33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
    "float64": [0.5, -1e300, float("inf")],
    "fixstr_and_str8": ["", "a" * 31, "b" * 32, "c" * 255, "ünï"],
    "str16_and_str32": ["d" * 256, "e" * 65536],
    "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
    "arrays": [[], list(range(15)), list(range(16)), list(range(65536))],
    "maps": [{}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
             {str(i): i for i in range(65536)}],
    "nested": {"a": [{"b": [1, {"c": None}]}], "d": {"e": {"f": "g"}}},
}


@pytest.mark.parametrize("kind", list(_VALUES))
def test_msgpack_type_codes(kind):
    value = {"v": _VALUES[kind]}
    for single_float in (False, True):
        blob = msgpack.packb(value, use_bin_type=True, use_single_float=single_float)
        got = msgpack_restore(blob)
        want = fser.msgpack_restore(blob)
        _assert_trees_equal(got, want)


def test_float32_and_ext_sizes():
    blob = msgpack.packb([1.5, -2.25], use_single_float=True)
    assert msgpack_restore(blob) == [1.5, -2.25]
    for n in (1, 70, 20000):                     # ext8, ext16, ext32 payloads
        tree = {"a": np.arange(n, dtype=np.float32)}
        _assert_trees_equal(msgpack_restore(fser.to_bytes(tree)), tree)


def test_malformed_input_raises():
    blob = fser.to_bytes({"a": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_restore(blob[:-2])
    with pytest.raises(ValueError, match="trailing"):
        msgpack_restore(blob + b"\x00")
    with pytest.raises(ValueError, match="ext type 9"):
        msgpack_restore(msgpack.packb(msgpack.ExtType(9, b"abcd")))
    with pytest.raises(ValueError, match="ext type 2"):     # a Python complex
        msgpack_restore(fser.to_bytes({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="0xc1"):
        msgpack_restore(b"\xc1")


def test_lists_come_back_keyed_by_index():
    """flax keys a list's entries "0", "1", ...; ``convert_params`` walks
    them as names, as a ``state_dict`` names a ``ModuleList``'s entries."""
    tree = {"a": [np.ones(2, np.float32), {"kernel": np.ones((2, 3), np.float32)}]}
    decoded = msgpack_restore(fser.to_bytes(tree))
    assert set(decoded["a"]) == {"0", "1"}
    assert sorted(flatten_params(decoded)) == ["a.0", "a.1.kernel"]


@pytest.fixture(scope="module")
def jax_model_folder(tmp_path_factory):
    """A trained-model folder as the JAX ``Trainer`` writes it: plans.json,
    dataset.json and, for folds 0 and 1, ``checkpoint_final.pth`` with the
    flax-serialised parameters of a deep-supervision M2NetP and its
    optimizer state."""
    import optax
    folder = tmp_path_factory.mktemp("jax_model")
    with open(folder / "plans.json", "w") as f:
        import json
        json.dump(PLANS, f)
    with open(folder / "dataset.json", "w") as f:
        json.dump(DATASET, f)
    params = []
    for fold in (0, 1):
        p = jax.tree_util.tree_map(np.asarray, _flax_params(seed=10 + fold))
        params.append(p)
        (folder / f"fold_{fold}").mkdir()
        ckpt = {"network_weights": fser.to_bytes(p),
                "optimizer_state": fser.to_bytes(optax.adamw(1e-3).init(p)),
                "step": 250, "logging": {}, "_best_ema": 0.5, "current_epoch": 1,
                "init_args": {"plans": PLANS, "configuration": "2d", "fold": fold,
                              "dataset_json": DATASET},
                "trainer_name": NAME, "inference_allowed_mirroring_axes": (0, 1)}
        with open(folder / f"fold_{fold}" / "checkpoint_final.pth", "wb") as f:
            pickle.dump(ckpt, f)
    return str(folder), params


def _volume():
    return (100 * np.random.RandomState(5).rand(1, 2, 40, 36)).astype(np.float32)


def test_a_jax_checkpoint_folder_predicts_the_same_in_the_port(jax_model_folder,
                                                               monkeypatch):
    folder, params = jax_model_folder
    monkeypatch.setitem(registry.MODEL_BUILDERS, NAME,
                        lambda *a, **k: tm2net.get_m2net_from_plans(
                            *a, **k, small=True, stage_layers=STAGES))
    tp = Predictor(use_mirroring=False, tile_batch_size=3, device="cpu")
    tp.initialize_from_trained_model_folder(folder)
    assert tp.trainer_name == NAME and len(tp.list_of_parameters) == 2
    assert tp.allowed_mirroring_axes == (0, 1)

    jpm = JaxPlans(PLANS)
    jp = JaxPredictor(use_mirroring=False, tile_batch_size=3)
    jp.manual_initialization(
        JaxM2NetP(num_classes=3, deep_supervision=False, stage_layers=STAGES),
        params, jpm, jpm.get_configuration("2d"), DATASET, NAME, (0, 1))
    want, want_prob = jp.predict_single_npy_array(
        _volume(), dict(PROPS), save_or_return_probabilities=True)
    got, got_prob = tp.predict_single_npy_array(
        _volume(), dict(PROPS), save_or_return_probabilities=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_prob, want_prob, rtol=0, atol=1e-3)

    from nnuzoo_tpu.preprocessing.preprocessor import DefaultPreprocessor as JPre
    data, _ = JPre().run_case_npy(_volume(), None, dict(PROPS), jpm,
                                  jpm.get_configuration("2d"), DATASET)
    want_logits = jp.predict_logits_from_preprocessed_data(data)
    got_logits = tp.predict_logits_from_preprocessed_data(data)
    span = float(want_logits.max() - want_logits.min())
    np.testing.assert_allclose(got_logits, want_logits, rtol=0, atol=1e-3 * span)

    # a checkpoint that is neither kind is refused
    bad = pickle.load(open(f"{folder}/fold_0/checkpoint_final.pth", "rb"))
    bad["network_weights"] = [1, 2]
    with open(f"{folder}/fold_0/checkpoint_bad.pth", "wb") as f:
        pickle.dump(bad, f)
    with pytest.raises(TypeError, match="neither a state_dict"):
        Predictor(device="cpu").initialize_from_trained_model_folder(
            folder, use_folds=[0], checkpoint_name="checkpoint_bad.pth")
