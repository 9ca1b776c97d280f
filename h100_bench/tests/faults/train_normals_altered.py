"""Fault: the normals the store build estimates are altered where they
are produced (turned away from the sensor)."""


def install():
    import rslo_tpu_torch.data.normals as normals
    orig = normals.estimate_normals

    def altered(xyz, radius=0.6, k=30):
        return -orig(xyz, radius, k)

    normals.estimate_normals = altered
