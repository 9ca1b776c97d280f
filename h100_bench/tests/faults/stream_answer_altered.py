"""Fault: the odometry of a scan pair is altered where it is produced
(a centimetre along x), so each pose the stream returns is off."""


def install():
    from rslo_tpu_torch.models.net import OdomNet
    orig = OdomNet.pair_predict

    def altered(self, bev_prev, bev_new):
        out = orig(self, bev_prev, bev_new)
        odom = out["odometry"].clone()
        odom[..., 0] += 0.01
        out["odometry"] = odom
        return out

    OdomNet.pair_predict = altered
