"""Vector/transform math over SoA arrays.

Replaces the reference's scalar Point/Vector/Normal/Transform classes
(/root/reference/src/core/geometry.h, src/core/transform.cpp) with
vectorized operations on arrays shaped [..., 3].  There are no classes:
rays are (o, d) array pairs, transforms are 4x4 matrices, and every op
broadcasts over leading batch dimensions so the whole wavefront is one
XLA program.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

# Large-but-finite ray bound. float32 infinity breaks t-interval math in
# XLA (inf*0 = nan), so we use a big finite sentinel like many GPU tracers.
INF = jnp.float32(1e30)
MACHINE_EPS = np.float32(np.finfo(np.float32).eps * 0.5)


def gamma(n: int) -> float:
    """pbrt's conservative floating-point error bound (n*eps)/(1-n*eps).

    Mirrors core/pbrt.h gamma(); used for watertight intersection offsets
    instead of the reference's full EFloat interval arithmetic
    (core/efloat.h) - on the device we use the closed-form bounds only.
    """
    ne = float(n) * float(MACHINE_EPS)
    return ne / (1.0 - ne)


def dot(a: Array, b: Array) -> Array:
    return jnp.sum(a * b, axis=-1)


def absdot(a: Array, b: Array) -> Array:
    return jnp.abs(dot(a, b))


def cross(a: Array, b: Array) -> Array:
    return jnp.cross(a, b)


def length_squared(v: Array) -> Array:
    return jnp.sum(v * v, axis=-1)


def length(v: Array) -> Array:
    return jnp.sqrt(length_squared(v))


def normalize(v: Array, eps: float = 1e-20) -> Array:
    return v * jax.lax.rsqrt(jnp.maximum(length_squared(v), eps))[..., None]


def face_forward(n: Array, v: Array) -> Array:
    """Flip n so it lies in the hemisphere of v (pbrt Faceforward)."""
    return jnp.where(dot(n, v)[..., None] < 0.0, -n, n)


def coordinate_system(v1: Array) -> tuple[Array, Array]:
    """Build an orthonormal basis around unit v1 (pbrt CoordinateSystem).

    Branchless variant of geometry.h:CoordinateSystem suitable for SIMD
    lanes: selects the formulation by |x|>|y| per-lane with where().
    """
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    cond = jnp.abs(x) > jnp.abs(y)
    inv_a = jax.lax.rsqrt(jnp.where(cond, x * x + z * z, y * y + z * z))
    v2 = jnp.where(
        cond[..., None],
        jnp.stack([-z * inv_a, jnp.zeros_like(x), x * inv_a], axis=-1),
        jnp.stack([jnp.zeros_like(x), z * inv_a, -y * inv_a], axis=-1),
    )
    v3 = cross(v1, v2)
    return v2, v3


def spherical_direction(sin_theta: Array, cos_theta: Array, phi: Array) -> Array:
    return jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1
    )


def distance(a: Array, b: Array) -> Array:
    return length(b - a)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


# ---------------------------------------------------------------------------
# 4x4 transforms (row-vector convention matching pbrt's column-vector matrices
# transposed; we store M such that p' = (M @ [p,1])[:3]).
# ---------------------------------------------------------------------------


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def translate(delta) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(delta, dtype=np.float32)
    return m


def scale_mat(s) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    s = np.broadcast_to(np.asarray(s, dtype=np.float32), (3,))
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate(angle_deg: float, axis) -> np.ndarray:
    """Rotation about arbitrary axis (transform.cpp:Rotate)."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    s = np.sin(np.radians(angle_deg))
    c = np.cos(np.radians(angle_deg))
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
    return m.astype(np.float32)


def look_at(eye, look, up) -> np.ndarray:
    """Camera-to-world matrix (transform.cpp:LookAt)."""
    eye = np.asarray(eye, dtype=np.float64)
    look = np.asarray(look, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    d = look - eye
    d = d / np.linalg.norm(d)
    right = np.cross(up / np.linalg.norm(up), d)
    rn = np.linalg.norm(right)
    if rn < 1e-12:
        raise ValueError("LookAt: up vector parallel to viewing direction")
    right = right / rn
    new_up = np.cross(d, right)
    m = np.eye(4, dtype=np.float64)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = eye
    return m.astype(np.float32)


def perspective(fov_deg: float, near: float, far: float) -> np.ndarray:
    """Perspective projection (transform.cpp:Perspective)."""
    persp = np.array(
        [
            [1, 0, 0, 0],
            [0, 1, 0, 0],
            [0, 0, far / (far - near), -far * near / (far - near)],
            [0, 0, 1, 0],
        ],
        dtype=np.float64,
    )
    inv_tan = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    return (scale_mat([inv_tan, inv_tan, 1.0]).astype(np.float64) @ persp).astype(
        np.float32
    )


def _apply33(rows, v):
    # Explicit elementwise form: width-3 matmuls may run in TF32 on the GPU;
    # this keeps full f32 and fuses into neighbors.
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack(
        [
            rows[0][0] * x + rows[0][1] * y + rows[0][2] * z,
            rows[1][0] * x + rows[1][1] * y + rows[1][2] * z,
            rows[2][0] * x + rows[2][1] * y + rows[2][2] * z,
        ],
        axis=-1,
    )


def transform_point(m: Array, p: Array) -> Array:
    """Apply 4x4 to points [..., 3] with homogeneous divide."""
    m = jnp.asarray(m)
    r = _apply33(m, p) + m[:3, 3]
    w = m[3, 0] * p[..., 0] + m[3, 1] * p[..., 1] + m[3, 2] * p[..., 2] + m[3, 3]
    return jnp.where(jnp.abs(w[..., None] - 1.0) < 1e-9, r, r / w[..., None])


def transform_vector(m: Array, v: Array) -> Array:
    return _apply33(jnp.asarray(m), v)


def transform_normal(m_inv: Array, n: Array) -> Array:
    """Normals transform by the inverse transpose: pass the INVERSE here."""
    m_inv = jnp.asarray(m_inv)
    mt = m_inv.T
    return _apply33(mt, n)


def np_transform_point(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    r = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3].T + m[3, 3]
    return np.where(np.abs(w[..., None] - 1.0) < 1e-9, r, r / w[..., None])


def np_transform_vector(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    return v @ m[:3, :3].T


def np_transform_normal(m_inv: np.ndarray, n: np.ndarray) -> np.ndarray:
    return n @ m_inv[:3, :3]


def offset_ray_origin(p: Array, p_err: Array, n: Array, w: Array) -> Array:
    """Robust ray-origin offset along the normal (geometry.h:OffsetRayOrigin).

    p_err is the per-component absolute intersection error bound.
    """
    d = dot(jnp.abs(n), p_err)
    offset = d[..., None] * n
    offset = jnp.where(dot(w, n)[..., None] < 0.0, -offset, offset)
    po = p + offset
    # Round offset point away from p (NextFloatUp/Down per component).
    up = jnp.where(offset > 0, jnp.nextafter(po, INF), po)
    return jnp.where(offset < 0, jnp.nextafter(po, -INF), up)
