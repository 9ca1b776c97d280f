"""Fault: the middle's gradients come out with the wrong sign (as a
feature gradient of the wrong sign through the sparse convs would give
them); every other leaf's are right."""


def install():
    import rslo_tpu_torch.train.step as step
    orig = step.loss_and_grads

    def flipped(*args, **kw):
        out, grads = orig(*args, **kw)
        return out, {k: -g if k.startswith("middle.") else g
                     for k, g in grads.items()}

    step.loss_and_grads = flipped
