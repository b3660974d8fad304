"""The port's configuration presets (``utils/config.py``): the JAX
package's presets with the same fields and defaults, plus ``device``
(``"cuda"``); each preset is taken by the parser of the port's trainer of
its name (its command line, rendered from the preset's fields, parses back
to the preset's values), and ``to_args(parser)`` fills the rest with the
parser's defaults; the SSD preset trains a step on the CPU."""

import dataclasses

import pytest

from vqvae2_tpu.utils import config as jc
from vqvae2_tpu_torch.utils import config as tc

TRAINERS = {"vqvae_ffhq_256": "vqvae", "pixelsnail_top": "pixelsnail",
            "pixelsnail_bottom": "pixelsnail", "reid_sysu": "reid",
            "ssd_modanet": "detection"}


def parser_of(name):
    import importlib

    return importlib.import_module(f"vqvae2_tpu_torch.train.{TRAINERS[name]}").build_argparser()


def test_the_presets_are_the_jax_packages_with_a_device():
    assert set(tc.PRESETS) == set(jc.PRESETS) == set(TRAINERS)
    for name, preset in tc.PRESETS.items():
        ours = dataclasses.asdict(preset)
        assert ours.pop("device") == "cuda"
        assert ours == dataclasses.asdict(jc.PRESETS[name]), name
    alt = tc.PRESETS["pixelsnail_top"].replace(hier="bottom")
    assert alt.to_args().hier == "bottom" and tc.PRESETS["pixelsnail_top"].hier == "top"


def command_line(preset, parser):
    """The preset as the trainer's command line."""
    positional = {a.dest for a in parser._actions if not a.option_strings}
    argv = [str(getattr(preset, d)) for d in positional]
    for field in dataclasses.fields(preset):
        value = getattr(preset, field.name)
        if field.name in positional:
            continue
        if isinstance(value, bool):
            argv += [f"--{field.name}"] if value else []
        else:
            argv += [f"--{field.name}", str(value)]
    return argv


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_each_preset_is_taken_by_its_trainers_parser(name):
    preset, parser = tc.PRESETS[name], parser_of(name)
    dests = {a.dest for a in parser._actions}
    assert {f.name for f in dataclasses.fields(preset)} <= dests
    parsed = vars(parser.parse_args(command_line(preset, parser)))
    full = vars(preset.to_args(parser))
    assert parsed == full, {k: (parsed.get(k), full.get(k)) for k in set(parsed) | set(full)
                            if parsed.get(k) != full.get(k)}


def test_the_ssd_preset_trains_on_the_cpu():
    from vqvae2_tpu_torch.train import detection

    preset = tc.PRESETS["ssd_modanet"].replace(synthetic=True, steps=1, batch_size=2,
                                               device="cpu", eval=False)
    m = detection.run_synthetic(detection.train, preset.to_args(detection.build_argparser()))
    assert m["loss"] == m["loss"]
