"""Stage-2 PixelSNAIL priors (port of ``vqvae2_tpu/train/pixelsnail.py``).

Only :func:`build_model` is here so far: it is what ``train/sample.py``
rebuilds the two priors with.  The trainer itself (the train step, the CLI)
arrives with the stage-2 training slice of the port, together with the bf16
compute mode (``args.bf16``), which this fp32 slice does not read.
"""

from __future__ import annotations

from vqvae2_tpu_torch.models.pixelsnail import PixelSNAIL


def build_model(hier: str, args, code_hw=(32, 64)) -> PixelSNAIL:
    """The top or bottom prior for code grids ``code_hw = (top, bottom)``.

    ``hier == "top"``: the unconditional attention prior over the top grid;
    anything else: the attention-free bottom prior conditioned on the top
    codes.  ``args`` carries ``n_class``, ``channel``, ``n_res_block``,
    ``n_res_channel``, ``dropout``, and ``n_out_res_block`` (top) or
    ``n_cond_res_block`` (bottom)."""
    top_hw, bot_hw = code_hw
    if hier == "top":
        return PixelSNAIL(
            shape=(top_hw, top_hw), n_class=args.n_class, channel=args.channel,
            kernel_size=5, n_block=4, n_res_block=args.n_res_block,
            res_channel=args.n_res_channel, dropout=args.dropout,
            n_out_res_block=args.n_out_res_block,
        )
    return PixelSNAIL(
        shape=(bot_hw, bot_hw), n_class=args.n_class, channel=args.channel,
        kernel_size=5, n_block=4, n_res_block=args.n_res_block,
        res_channel=args.n_res_channel, attention=False, dropout=args.dropout,
        n_cond_res_block=args.n_cond_res_block,
        cond_res_channel=args.n_res_channel,
    )
