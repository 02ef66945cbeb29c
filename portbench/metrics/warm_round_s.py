"""The set-up's first round, the trainer's packing of the data included
(the base and SVD++ solvers pack a dataset in its first round): the
benchmark's span around it."""


def read(ctx):
    return ctx.warm_round_s
