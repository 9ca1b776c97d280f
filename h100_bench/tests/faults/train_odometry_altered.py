"""Fault: the pair motions a window's batch carries are altered where
the dataset produces them (a centimetre along x)."""


def install():
    import rslo_tpu_torch.data.dataset as dataset
    orig = dataset.generate_cyc_vo

    def altered(pose_seq):
        out = orig(pose_seq)
        out[:, 0] += 0.01
        return out

    dataset.generate_cyc_vo = altered
