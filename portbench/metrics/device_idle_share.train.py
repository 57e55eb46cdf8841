"""Share of the traced span of training epochs in which no kernel, copy or
memset ran on the card, in percent."""

from portbench.stats import idle_share


def read(rec):
    if not rec.on_card or rec.trace is None or rec.kind != "train":
        return None
    w = rec.trace.spans("portbench.window")[0]
    return idle_share(rec.trace.busy(), [(w.start, w.end)]) * 100.0
