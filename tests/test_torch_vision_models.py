"""paddle_tpu_torch's MobileNetV1 training step against the JAX
package's on the CPU (``torch_vision_parity``: the sizes, references and
limits), and the full-width VGG and MobileNet models' state names and
shapes, the converters' refusals and bfloat16, the default device.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.models.vision import mobilenet as jmb, vgg as jvgg
from paddle_tpu_torch import convert
from paddle_tpu_torch.models.vision import (MobileNetV1, MobileNetV2, VGG,
                                            mobilenet, vgg16, vgg19)

from torch_vision_parity import (_port_zero_initializers, _state,  # noqa: F401
                                 _zero_initializers, jax_runs,
                                 one_torch_thread, parity_tests, port_once)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


(test_logits_match, test_every_gradient_matches,
 test_batch_norm_buffers_after_one_step,
 test_train_step_trajectory_matches) = parity_tests("mobilenet_v1")


@pytest.mark.parametrize("name", ["vgg16", "vgg19", "mobilenet_v1",
                                  "mobilenet_v2"])
def test_full_width_state_has_the_reference_names_and_shapes(name):
    """The full-width models' state dicts (parameters and BatchNorm
    buffers) against the JAX ones', built only; the JAX one's loads
    through ``convert``."""
    jmake, tmake, conv = {
        "vgg16": (jvgg.vgg16, vgg16, convert.vgg_params_from_jax),
        "vgg19": (jvgg.vgg19, vgg19, convert.vgg_params_from_jax),
        "mobilenet_v1": (jmb.MobileNetV1, MobileNetV1,
                         convert.mobilenet_params_from_jax),
        "mobilenet_v2": (jmb.MobileNetV2, MobileNetV2,
                         convert.mobilenet_params_from_jax)}[name]
    with _zero_initializers():
        want = {k: tuple(v.shape) for k, v in jmake().state_dict().items()}
    with _port_zero_initializers():
        m = tmake(device="cpu")
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert list(got) == list(want)
    assert got == want
    params = {"vgg16": 138365992, "vgg19": 143678248,
              "mobilenet_v1": 4231976, "mobilenet_v2": 3504872}[name]
    assert sum(p.numel() for p in m.parameters()) == params
    m.load_state_dict(conv({k: np.zeros(s, np.float32)
                            for k, s in want.items()}))


def test_converters_refuse_what_does_not_fit():
    for name, conv, bad_name in (
            ("vgg11", convert.vgg_params_from_jax, "features.4.weight"),
            ("mobilenet_v2", convert.mobilenet_params_from_jax,
             "blocks.3.block.1.conv.weight"),
            ("mobilenet_v1", convert.mobilenet_params_from_jax,
             "blocks.5.dw.conv.weight")):
        sd = _state(name, "float32")
        assert set(conv(sd)) == set(sd)
        missing = {k: v for k, v in sd.items() if not k.endswith(
            "_variance") or "3" not in k}
        extra = dict(sd, **{"fc.extra": np.zeros(3, np.float32)})
        a = sd[bad_name]
        bad = dict(sd, **{bad_name: np.zeros(a.shape[:1] + (a.shape[1] + 1,)
                                             + a.shape[2:], np.float32)})
        for wrong in (missing, extra, bad):
            with pytest.raises(ValueError):
                conv(wrong)
    v2 = _state("mobilenet_v2", "float32")
    short = {k: v for k, v in v2.items() if not k.startswith("blocks.16.")}
    with pytest.raises(ValueError, match="blocks"):
        convert.mobilenet_params_from_jax(short)
    with pytest.raises(ValueError):
        convert.vgg_params_from_jax(v2)
    with pytest.raises(ValueError):
        convert.mobilenet_params_from_jax(_state("vgg11", "float32"))


def test_converters_keep_bfloat16():
    for name, conv in (("mobilenet_v1", convert.mobilenet_params_from_jax),
                       ("vgg11", convert.vgg_params_from_jax)):
        sd = _state(name, "bfloat16")
        assert {str(a.dtype) for a in sd.values()} == {"bfloat16"}
        got = conv(sd)
        assert {t.dtype for t in got.values()} == {torch.bfloat16}
        for k, t in got.items():
            np.testing.assert_array_equal(t.float().numpy(),
                                          sd[k].astype(np.float32), err_msg=k)


def test_models_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    for make in (lambda: MobileNetV1(scale=0.25),
                 lambda: MobileNetV2(scale=0.25), lambda: VGG(11)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert isinstance(mobilenet.MobileNetV2(scale=0.25, device="cpu"),
                      torch.nn.Module)
