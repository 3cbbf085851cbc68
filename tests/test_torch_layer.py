"""``nn.Layer`` (an ``nn.Module``) against the JAX ``Layer``: the LLaMA's
state-dict keys in the JAX order, hooks, ``train``/``eval``, ``to``,
``apply``, ``parameters``, ``set_state_dict``, ``create_parameter``; and
torch's own calls into the clashing methods (``eval()``, ``state_dict``
with ``prefix=``, ``parameters(recurse=)``) still work."""
import numpy as np
import pytest
import torch

import paddle_tpu as J
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
import paddle_tpu_torch as P
from paddle_tpu_torch.core import device as pdev
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.layer import Layer, Linear, Sequential

TINY = dict(vocab=32, hidden=16, layers=2, heads=2, inter=32)


@pytest.fixture(autouse=True)
def _cpu():
    prev = getattr(pdev._state, "device", None)
    P.set_device("cpu")
    yield
    pdev._state.device = prev


def test_llama_state_dict_keys_and_order_equal_jax():
    jm = JaxLlama(JaxConfig.tiny(**TINY))
    pm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    assert list(pm.state_dict()) == list(jm.state_dict())
    assert [n for n, _ in pm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    assert isinstance(pm, Layer) and isinstance(pm.llama.norm, Layer)
    assert len(pm.parameters()) == len(jm.parameters())
    assert len(pm.parameters(include_sublayers=False)) == \
        len(jm.parameters(include_sublayers=False)) == 0
    assert [n for n, _ in pm.named_sublayers()][:3] == \
        [n for n, _ in jm.named_sublayers()][:3]


class _Net(Layer):
    def __init__(self):
        super().__init__()
        self.fc = Linear(4, 3, device="cpu")
        self.w = self.create_parameter([3], is_bias=True, device="cpu")
        self.register_buffer("count", torch.zeros(1))
        self.register_buffer("scratch", torch.zeros(1), persistable=False)

    def forward(self, x):
        return self.fc(x) + self.w


def test_buffers_hooks_and_state_dict():
    net = _Net()
    assert list(net.state_dict()) == ["w", "fc.weight", "fc.bias", "count"]
    assert isinstance(net.w, P.Parameter) and not net.w.stop_gradient
    outer = torch.nn.Module()
    outer.net = net
    assert list(outer.state_dict()) == ["net.w", "net.count",
                                        "net.fc.weight", "net.fc.bias"]
    assert list(net.state_dict(include_sublayers=False)) == ["w", "count"]
    seen = []
    pre = net.register_forward_pre_hook(
        lambda layer, inp: (inp[0] * 0,))
    post = net.register_forward_post_hook(
        lambda layer, inp, out: seen.append(out.shape) or out + 1)
    out = net(P.to_tensor(np.ones((2, 4), np.float32)))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.ones((2, 3)) + net.fc.bias.detach().numpy()
                               + net.w.detach().numpy())
    assert seen == [torch.Size([2, 3])]
    pre.remove()
    post.remove()
    assert not net._forward_pre_hooks and not net._forward_hooks
    missing, unexpected = net.set_state_dict(
        {"w": np.full(3, 2.0), "extra": np.zeros(1)})
    assert "fc.weight" in missing and unexpected == ["extra"]
    np.testing.assert_array_equal(net.w.detach().numpy(), [2.0] * 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        net.set_state_dict({"w": np.zeros(4)})


def test_train_eval_apply_to_and_torch_calls():
    net = Sequential(_Net(), Linear(3, 2, device="cpu"))
    jnet = J.nn.Sequential(J.nn.Linear(4, 3), J.nn.Linear(3, 2))
    net.eval()                                   # torch: self.train(False)
    assert not any(m.training for m in net.sublayers(include_self=True))
    net.train()
    assert all(m.training for m in net.sublayers(include_self=True))
    order, jorder = [], []
    net.apply(lambda m: order.append(type(m).__name__))
    jnet.apply(lambda m: jorder.append(type(m).__name__))
    assert order[0] == jorder[0] == "Sequential"
    net.to(dtype="float16")
    assert net[0].fc.weight.dtype == torch.float16
    assert net[0].count.dtype == torch.float16
    net.to("cpu", "float32", True)
    assert net[0].fc.weight.dtype == torch.float32
    net.to(torch.float64)
    assert net[1].weight.dtype == torch.float64
    assert len(list(net.parameters(recurse=False))) == 0
    assert list(net.state_dict(prefix="m.", keep_vars=True))[0] == "m.0.w"
    net.clear_gradients()
    assert net.full_name() == "sequential"
