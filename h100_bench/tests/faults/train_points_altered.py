"""Fault: the points a frame of the store reads back are altered where
the reader produces them (a centimetre along x)."""


def install():
    from rslo_tpu_torch.data.hdf5_store import SequenceReader
    orig = SequenceReader.frame

    def altered(self, i, cross_normals=False):
        out = orig(self, i, cross_normals)
        out["points"][:, 0] += 0.01
        return out

    SequenceReader.frame = altered
