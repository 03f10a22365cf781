"""Seconds of the model's construction (``LdaModel.__init__``: the tier, the
deferred layout, the initial state, the sweep function), the card waited
for, on the host's clock."""


def read(ctx):
    return ctx.host.get("model_init_s")
