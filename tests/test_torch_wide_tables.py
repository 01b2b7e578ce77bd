"""The port's wide-BVH tables vs the JAX package's: ``wide_rows``,
``wide_root`` and ``tri_shade`` byte-equal for every shipped layout and leaf
bundle, the layouts' geometry equal, and ``scene_from_jax`` carries a wide
JAX scene across byte for byte.

The JAX side packs with its default implementation (its C++ one where that
compiles, else its Python one: the two share a byte-identity contract); the
port has the Python one only, so this holds it to the same contract."""

import numpy as np
import pytest

from pathtracing_tpu.accel import wide as jwide
from pathtracing_tpu_torch.accel import wide as twide
from pathtracing_tpu_torch.convert import scene_from_jax
from pathtracing_tpu_torch.scene import golden as tgolden
from pathtracing_tpu_torch.testing import assert_same_tables, golden, n

import golden_scene as jgolden

LAYOUTS = ("w8", "w16", "s8")
WIDE_FIELDS = ("wide_rows", "wide_root", "tri_shade")


@pytest.mark.parametrize("leaf_bundle", [None, 8, 1])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_wide_tables_byte_equal(layout, leaf_bundle):
    g = golden("scene.gold")
    kw = dict(wide=True, leaf_bundle=leaf_bundle, wide_layout=layout)
    ts = tgolden.scene_device_from_golden(g, device="cpu", **kw)
    js = jgolden.scene_device_from_golden(g, **kw)
    for k in WIDE_FIELDS:
        assert getattr(ts, k) is not None and getattr(js, k) is not None, k
    assert ts.wide_root_base is None and js.wide_root_base is None
    assert_same_tables(ts, js)
    lay = twide.LAYOUTS_BY_WIDTH[ts.wide_rows.shape[1]]
    assert (lay.n_slots, lay.leaf_tris, lay.stub) == {
        "w8": (8, 4, False), "w16": (16, 8, False), "s8": (8, 8, True)
    }[layout]
    # link columns are bit patterns: sentinels (NaN patterns) and small
    # cursors (subnormals) must have come through the upload
    bits = n(ts.wide_rows).view(np.uint32)
    assert (bits[:, lay.exit_col] == np.uint32(twide.END_BLAS)).any()
    assert (bits[:, lay.exit_col] == np.uint32(twide.END_TLAS)).any()
    assert ((bits[:, lay.links_col] > 0) & (bits[:, lay.links_col] < 0x00800000)).any()


@pytest.mark.parametrize("name", ["LAYOUT_W8", "LAYOUT_W16", "LAYOUT_S8"])
def test_layout_fields_equal(name):
    a, b = getattr(twide, name), getattr(jwide, name)
    assert vars(a).keys() == vars(b).keys()
    for k, v in vars(b).items():
        assert getattr(a, k) == v and type(getattr(a, k)) is type(v), k
    assert twide.LAYOUTS_BY_WIDTH[a.w_row] is a
    assert int(a.make_cursor(twide.KIND_INST, 5, 3)) == int(b.make_cursor(jwide.KIND_INST, 5, 3))


def test_constants_equal():
    for k in ("KIND_WIDE", "KIND_LEAF", "KIND_INST", "KIND_SENTINEL", "END_TLAS",
              "END_BLAS", "RETURN_SENTINEL", "_INVALID"):
        assert int(getattr(twide, k)) == int(getattr(jwide, k)), k
    assert sorted(twide.LAYOUTS_BY_WIDTH) == sorted(jwide.LAYOUTS_BY_WIDTH) == [40, 48, 88]


def test_bf16_rounding_is_outward_on_the_bit_pattern():
    xs = np.array([0.1, -0.1, 1.0, -3.0000002, 123.456, -1e-30, 0.0], np.float32)
    for x in xs:
        for up in (False, True):
            a, b = twide._round_bf16(x, up), jwide._round_bf16(x, up)
            assert int(a) == int(b)
            back = np.array([int(a) << 16], np.uint32).view(np.float32)[0]
            assert back >= x if up else back <= x
    lo, hi = xs[:3], xs[3:6]
    assert twide._pack_slot_aabb(lo, hi).tobytes() == jwide._pack_slot_aabb(lo, hi).tobytes()
    assert twide._empty_slot_aabb().tobytes() == jwide._empty_slot_aabb().tobytes()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_scene_from_jax_carries_wide_tables(layout):
    js = jgolden.scene_device_from_golden(
        golden("scene.gold"), wide=True, leaf_bundle=None, wide_layout=layout
    )
    fields = {k: np.asarray(v) for k, v in js._asdict().items() if v is not None}
    ts = scene_from_jax(fields, device="cpu")
    assert_same_tables(ts, js)
    assert ts.wide_rows is not None and ts.tri_shade is not None


def test_frame_tail_addresses_the_static_region():
    """The two-part build (static BLAS region + per-frame tail) that
    ``build_wide_tables`` composes: tail cursors are absolute, a root base
    shifts the root table, and a TLAS below the base is refused."""
    g = golden("scene.gold")
    inst = [tgolden._GoldenInstance(u, f) for u, f in zip(g["instances_u"], g["instances_f"])]
    jinst = [jgolden._GoldenInstance(u, f) for u, f in zip(g["instances_u"], g["instances_f"])]
    arrays = (g["indices"], g["pos"], g["normal"], g["albedo"], g["material"])
    count, off = int(g["tlas"][0]), int(g["tlas"][1])

    class SF:
        def __init__(self, handle):
            self.tlas = handle

    from pathtracing_tpu.accel.types import BvhHandle as JBvh
    from pathtracing_tpu_torch.accel.types import BvhHandle

    st = twide.WideStaticRegion(arrays, g["nodes"], g["links"], [(i.mesh, i.blas) for i in inst])
    jst = jwide.WideStaticRegion(arrays, g["nodes"], g["links"], [(i.mesh, i.blas) for i in jinst])
    assert st.rows.tobytes() == jst.rows.tobytes()
    tail, root = twide.build_frame_tail(
        st, g["nodes"], g["links"], inst, [SF(BvhHandle(count, off))], root_base=off
    )
    jtail, jroot = jwide.build_frame_tail(
        jst, g["nodes"], g["links"], jinst, [SF(JBvh(count, off))], root_base=off
    )
    assert tail.tobytes() == jtail.tobytes() and root.tobytes() == jroot.tobytes()
    assert root.shape == (1, 8) and root.dtype == np.int32
    rows_i, cur_i = twide._inst_rows_np(st.layout, inst, st.blas_roots, len(st.rows))
    assert rows_i.tobytes() == tail[: len(inst)].tobytes()
    assert (cur_i >> 30 == twide.KIND_INST).all()
    with pytest.raises(ValueError, match="root_base"):
        twide.build_frame_tail(
            st, g["nodes"], g["links"], inst, [SF(BvhHandle(count, off))], root_base=off + 1
        )
