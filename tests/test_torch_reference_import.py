"""A reference-layout ``PixelSNAIL`` ``state_dict`` (weight norm's
``weight_v``/``weight_g``, the causal convolutions' ``.conv.conv`` and the
gated blocks' prefixes) to and from the port's ``PixelSNAIL``
(``utils/jax_import.py``): the port's export, read by the JAX package's
``import_pixelsnail``, gives the JAX model the port's logits (rtol 2e-4 /
atol 2e-5, as ``tests/test_torch_pixelsnail.py``); the export read back by
the port fills every parameter with the same values.  Both tiny
configurations of the PixelSNAIL tests: the top prior (attention, an output
residual block) and the bottom prior (no attention, the conditioning
network)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvae2_tpu.utils.torch_import import import_pixelsnail
from vqvae2_tpu_torch.models import pixelsnail as tps
from vqvae2_tpu_torch.utils import jax_import

from test_torch_pixelsnail import BOTTOM, TOP, close, japply, make_pair


@pytest.mark.parametrize("which", ["top", "bottom"])
def test_the_export_gives_the_jax_model_the_ports_logits(which):
    jmodel, variables, model, codes, cond = make_pair(which)
    sd = jax_import.to_reference_pixelsnail_state_dict(model)
    assert all(k.endswith((".weight_v", ".weight_g", ".bias")) for k in sd)
    assert "horizontal.conv.conv.weight_v" in sd and "out.{}.conv.weight_v".format(
        len(model.out_res) + 1) in sd
    # scrambled JAX weights, then every one read from the export
    scrambled = {"params": jax_import_tree_map(lambda a: a * 0 + 0.5, variables["params"])}
    imported = import_pixelsnail(sd, scrambled)
    condition = None if cond is None else jnp.asarray(cond)
    want = japply(jmodel, imported, jnp.asarray(codes), condition=condition)
    with torch.no_grad():
        got = model(torch.from_numpy(codes),
                    condition=None if cond is None else torch.from_numpy(cond))
    close(got, want, which)


@pytest.mark.parametrize("which", ["top", "bottom"])
def test_the_export_reads_back(which):
    _, _, model, _, _ = make_pair(which)
    sd = jax_import.to_reference_pixelsnail_state_dict(model)
    other = tps.PixelSNAIL(**(TOP if which == "top" else BOTTOM))
    other.load_state_dict(jax_import.from_reference_pixelsnail_state_dict(sd, other))
    for name, value in model.state_dict().items():
        assert torch.equal(other.state_dict()[name], value), name
    with pytest.raises(KeyError, match="lacks"):
        jax_import.from_reference_pixelsnail_state_dict(
            {k: v for k, v in sd.items() if not k.startswith("vertical.")}, other)


def jax_import_tree_map(fn, tree):
    return {k: jax_import_tree_map(fn, v) if isinstance(v, dict) else fn(np.asarray(v))
            for k, v in tree.items()}
