"""Victoria Park lidar tree-detection measurement model.

Reference: MeasurementModel_VictoriaPark.cpp.  Measurements are
``[range, bearing, tree-diameter]``; landmarks are
``[x, y, diameter]`` (Landmark3d).  The 2-D part wraps the range-bearing
model with the pose rotated by -pi/2 (the lidar's frame,
MeasurementModel_VictoriaPark.cpp:112-114); the diameter channel's variance
grows with range^2 * Slb (beam-angle variance, :131).

Probability of detection is scan-dependent: the model counts the 0.5-degree
lidar beams (361-beam scan on a 720-bin circle) that could hit the tree disc
— beams in the angular window subtended by the disc whose return range is
beyond ``range - radius - 0.18`` (or zero = no return) — and looks the count
up in a configured table (:202-265).  Detection is additionally probed at
perpendicular offsets of +-2*diameter up to 3 sigma of the landmark's
cross-range uncertainty, taking the max Pd (:153-199); the probe count is
capped at ``N_PROBE_PAIRS`` pairs (the reference iterates until the offset
exceeds 3 sigma).

When no raw scan is available (the repository's dataset ships without
LASER.txt), ``has_scan=False`` falls back to assuming every beam in the
window returns: numPoints = maxNumPoints, i.e. Pd depends only on geometry
and the table.

Note: the reference computes the probe direction from
``atan2(bearing, range) + theta`` (MeasurementModel_VictoriaPark.cpp:166),
which mixes measurement components; we use the intended world-frame
direction to the landmark.  The reference also indexes its 361-entry scan
with up-to-720 bins (:250-253, out of bounds); we keep a 720-bin scan padded
with zeros (zero = "no return", which counts as visible).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from rfs_slam_tpu.core import gaussian, struct
from rfs_slam_tpu.models.measurement import MeasurePrediction

N_PROBE_PAIRS = 3
BEAM_WINDOW = 32  # max beams in a tree's angular window (>= 2*gamma*720/2pi)


class VictoriaPark(struct.PyTreeNode):
    """Attributes (reference Config: MeasurementModel_VictoriaPark.hpp:136-145).

    ``pd_table`` is the beam-count -> Pd lookup (XML <Pd><value>...),
    ``scan720`` the current 720-bin scan (721 zeros when absent), and
    ``clutter_value`` the per-scan clutter intensity
    (expectedClutterNumber / scan FoV area, :267-286).
    """

    R: jax.Array                     # [3, 3] (inflated)
    slb: jax.Array                   # beam-angle variance (varza)
    pd_table: jax.Array              # [K]
    r_max: jax.Array = struct.field(default=70.0)
    r_min: jax.Array = struct.field(default=5.0)
    b_max: jax.Array = struct.field(default=3.09)   # radians
    b_min: jax.Array = struct.field(default=0.11)
    buffer_pd: jax.Array = struct.field(default=0.4)
    expected_clutter: jax.Array = struct.field(default=3.0)
    clutter_value: jax.Array = struct.field(default=1e-4)
    scan720: jax.Array = struct.field(default_factory=lambda: np.zeros((720,), np.float32))
    has_scan: bool = struct.field(pytree_node=False, default=False)

    # ------------------------------------------------------------- measure
    def measure(self, pose, lm_mean, lm_cov=None) -> MeasurePrediction:
        th = pose[..., 2] - jnp.pi / 2.0
        dx = lm_mean[..., 0] - pose[..., 0]
        dy = lm_mean[..., 1] - pose[..., 1]
        r2 = dx * dx + dy * dy
        r = jnp.sqrt(r2)
        b = gaussian.wrap_angle(jnp.arctan2(dy, dx) - th)
        z = jnp.stack([r, b, lm_mean[..., 2]], axis=-1)

        # clamped Jacobian denominators: finite H for a landmark exactly at
        # the sensor (dead slots + origin pose) — see models/measurement.py
        r2s = jnp.maximum(r2, gaussian.R2_TINY)
        rs = jnp.sqrt(r2s)
        zero = jnp.zeros_like(r)
        one = jnp.ones_like(r)
        H = jnp.stack(
            [
                jnp.stack([dx / rs, dy / rs, zero], axis=-1),
                jnp.stack([-dy / r2s, dx / r2s, zero], axis=-1),
                jnp.stack([zero, zero, one], axis=-1),
            ],
            axis=-2,
        )
        S = jnp.broadcast_to(self.R, z.shape + (3,))
        if lm_cov is not None:
            # 2-D block via H2d; diameter: cov_dd + R_dd + r^2 * Slb
            S = S + gaussian.sandwich(H, lm_cov)
        S = S.at[..., 2, 2].add(r2 * self.slb)
        valid = jnp.ones_like(r, bool)  # measure() always succeeds (:148)
        H_pose = jnp.zeros(z.shape + (3,))
        return MeasurePrediction(z, S, H, H_pose, valid)

    def measure_p(self, pose, mean, cov=None):
        """Plane-layout measure: ``mean[3, ...]`` (x, y, diameter),
        ``cov[6, ...]`` packed.  See MeasurementModel_VictoriaPark.cpp:96-135."""
        from rfs_slam_tpu.core import planar
        from rfs_slam_tpu.models.measurement import PlanarPrediction

        th = pose[..., 2] - jnp.pi / 2.0
        dx = mean[0] - pose[..., 0]
        dy = mean[1] - pose[..., 1]
        r2 = dx * dx + dy * dy
        r = jnp.sqrt(r2)
        b = gaussian.wrap_angle(jnp.arctan2(dy, dx) - th)
        # clamped Jacobian denominators: see measure()
        r2s = jnp.maximum(r2, gaussian.R2_TINY)
        rs = jnp.sqrt(r2s)
        zero = jnp.zeros_like(r)
        one = jnp.ones_like(r)
        H = [
            [dx / rs, dy / rs, zero],
            [-dy / r2s, dx / r2s, zero],
            [zero, zero, one],
        ]
        if cov is not None:
            S = planar.sandwich_sym(H, cov, 3, R=self.R)
        else:
            S = jnp.stack([
                jnp.broadcast_to(self.R[i, j], r.shape)
                for i in range(3) for j in range(i, 3)
            ])
        S = S.at[planar.tri_index(2, 2, 3)].add(r2 * self.slb)
        valid = jnp.ones_like(r, bool)
        return PlanarPrediction((r, b, mean[2] + zero), S, H, valid)

    def inverse_p(self, pose, z):
        """Plane-layout inverse: z = (range, bearing, diameter) planes."""
        from rfs_slam_tpu.core import planar

        th = pose[..., 2] - jnp.pi / 2.0
        a = th + z[1]
        c, s = jnp.cos(a), jnp.sin(a)
        r = z[0]
        mx = pose[..., 0] + r * c
        my = pose[..., 1] + r * s
        md = jnp.broadcast_to(z[2], mx.shape)
        mean = jnp.stack([mx, my, md])
        Hinv = [[c, -r * s], [s, r * c]]
        cov2 = planar.sandwich_sym(Hinv, planar.pack_sym(self.R[:2, :2]), 2)
        zero = jnp.zeros_like(mx)
        cov = jnp.stack([
            cov2[0] + zero, cov2[1] + zero, zero,
            cov2[2] + zero, zero,
            jnp.broadcast_to(self.R[2, 2], mx.shape),
        ])
        return mean, cov

    def _pd_single_p(self, pose, lx, ly, diameter):
        """Plane-layout probabilityOfDetection2 (:202-265)."""
        K = self.pd_table.shape[0]
        pd_table = jnp.asarray(self.pd_table)
        th = pose[..., 2] - jnp.pi / 2.0
        dx = lx - pose[..., 0]
        dy = ly - pose[..., 1]
        rng = jnp.sqrt(dx * dx + dy * dy)
        ang = gaussian.wrap_angle(jnp.arctan2(dy, dx) - th)

        in_limits = (
            (ang <= self.b_max) & (ang >= self.b_min)
            & (rng >= self.r_min) & (rng <= self.r_max)
        )
        radius = diameter / 2.0
        gamma = jnp.arctan(radius / rng)
        max_pts = jnp.floor(2.0 * gamma * 720.0 / (2.0 * jnp.pi)).astype(jnp.int32)
        max_pts_c = jnp.clip(max_pts, 0, K - 1)
        geo_zero = (max_pts < K) & (pd_table[max_pts_c] == 0.0)
        close = (max_pts < K) & (pd_table[max_pts_c] < self.buffer_pd)

        if self.has_scan:
            minb = jnp.ceil((ang - gamma) * 720.0 / (2.0 * jnp.pi)).astype(jnp.int32)
            minb = jnp.mod(minb, 720)
            offs = jnp.arange(BEAM_WINDOW)
            bins = jnp.mod(minb[..., None] + offs, 720)
            scan_v = jnp.asarray(self.scan720)[bins]
            minrange = rng - radius - 6.0 * 0.03
            visible = (scan_v > minrange[..., None]) | (scan_v == 0.0)
            in_win = offs < jnp.minimum(max_pts, BEAM_WINDOW)[..., None]
            num_pts = jnp.sum(visible & in_win, axis=-1)
        else:
            num_pts = max_pts
        num_pts = jnp.clip(num_pts, 0, K - 1)
        pd = pd_table[num_pts]
        close = jnp.where(pd == 0.0, False, close)
        pd = jnp.where(in_limits & ~geo_zero, pd, 0.0)
        return pd, close & in_limits

    def pd_p(self, pose, mean, cov=None):
        """Plane-layout multi-probe Pd (probabilityOfDetection, :153-199)."""
        lx, ly, diameter = mean[0], mean[1], mean[2]
        dx = lx - pose[..., 0]
        dy = ly - pose[..., 1]
        bearing = jnp.arctan2(dy, dx)
        px, py = -jnp.sin(bearing), jnp.cos(bearing)

        if cov is not None:
            # perpendicular variance of the (x, y) block: packed idx 0,1,3
            var_perp = px * px * cov[0] + 2.0 * px * py * cov[1] + py * py * cov[3]
            std = jnp.maximum(3.0 * jnp.sqrt(jnp.maximum(var_perp, 0.0)), 0.2)
        else:
            std = jnp.full_like(diameter, 0.2)

        pd_c, close_c = self._pd_single_p(pose, lx, ly, diameter)
        pd_max, pd_min = pd_c, pd_c
        for i in range(1, N_PROBE_PAIRS + 1):
            probe_valid = (i - 1) * 2.0 * diameter < std
            for sgn in (1.0, -1.0):
                off = sgn * i * 2.0 * diameter
                pd_i, _ = self._pd_single_p(
                    pose, lx + off * px, ly + off * py, diameter
                )
                pd_i = jnp.where(probe_valid, pd_i, pd_c)
                pd_max = jnp.maximum(pd_max, pd_i)
                pd_min = jnp.minimum(pd_min, pd_i)
        close = close_c | ((pd_min == 0.0) & (pd_max > 0.0))
        return pd_max, close

    def inverse(self, pose, z):
        th = pose[..., 2] - jnp.pi / 2.0
        a = th + z[..., 1]
        c, s = jnp.cos(a), jnp.sin(a)
        r = z[..., 0]
        mean = jnp.stack(
            jnp.broadcast_arrays(
                pose[..., 0] + r * c, pose[..., 1] + r * s, z[..., 2]
            ),
            axis=-1,
        )
        Hinv = jnp.stack(
            [jnp.stack([c, -r * s], axis=-1), jnp.stack([s, r * c], axis=-1)],
            axis=-2,
        )
        cov2 = gaussian.sandwich(Hinv, self.R[:2, :2])
        cov = jnp.zeros(mean.shape + (3,))
        cov = cov.at[..., :2, :2].set(cov2)
        cov = cov.at[..., 2, 2].set(self.R[2, 2])
        return mean, cov

    # ------------------------------------------------------------------ Pd
    def _pd_single(self, pose, xy, diameter):
        """Pd of a disc at ``xy`` (probabilityOfDetection2, :202-265).

        Returns (pd, close, in_window_zero) — all shaped like ``diameter``.
        """
        K = self.pd_table.shape[0]
        pd_table = jnp.asarray(self.pd_table)
        th = pose[..., 2] - jnp.pi / 2.0
        dx = xy[..., 0] - pose[..., 0]
        dy = xy[..., 1] - pose[..., 1]
        rng = jnp.sqrt(dx * dx + dy * dy)
        ang = gaussian.wrap_angle(jnp.arctan2(dy, dx) - th)

        in_limits = (
            (ang <= self.b_max) & (ang >= self.b_min)
            & (rng >= self.r_min) & (rng <= self.r_max)
        )
        radius = diameter / 2.0
        gamma = jnp.arctan(radius / rng)
        max_pts = jnp.floor(2.0 * gamma * 720.0 / (2.0 * jnp.pi)).astype(jnp.int32)
        max_pts_c = jnp.clip(max_pts, 0, K - 1)
        # if even the max beam count maps to Pd 0, detection is impossible
        geo_zero = (max_pts < K) & (pd_table[max_pts_c] == 0.0)
        close = (max_pts < K) & (pd_table[max_pts_c] < self.buffer_pd)

        if self.has_scan:
            minb = jnp.ceil((ang - gamma) * 720.0 / (2.0 * jnp.pi)).astype(jnp.int32)
            minb = jnp.mod(minb, 720)
            offs = jnp.arange(BEAM_WINDOW)
            bins = jnp.mod(minb[..., None] + offs, 720)
            scan_v = jnp.asarray(self.scan720)[bins]
            minrange = rng - radius - 6.0 * 0.03
            visible = (scan_v > minrange[..., None]) | (scan_v == 0.0)
            in_win = offs < jnp.minimum(max_pts, BEAM_WINDOW)[..., None]
            num_pts = jnp.sum(visible & in_win, axis=-1)
        else:
            num_pts = max_pts
        num_pts = jnp.clip(num_pts, 0, K - 1)
        pd = pd_table[num_pts]
        close = jnp.where(pd == 0.0, False, close)
        pd = jnp.where(in_limits & ~geo_zero, pd, 0.0)
        return pd, close & in_limits

    def pd(self, pose, lm_mean, lm_cov=None):
        """Multi-probe Pd (probabilityOfDetection, :153-199)."""
        xy = lm_mean[..., :2]
        diameter = lm_mean[..., 2]
        th = pose[..., 2] - jnp.pi / 2.0
        dx = xy[..., 0] - pose[..., 0]
        dy = xy[..., 1] - pose[..., 1]
        bearing = jnp.arctan2(dy, dx)  # world direction to landmark
        perp = jnp.stack([-jnp.sin(bearing), jnp.cos(bearing)], axis=-1)

        if lm_cov is not None:
            var_perp = gaussian.quad_form(lm_cov[..., :2, :2], perp)
            std = jnp.maximum(3.0 * jnp.sqrt(jnp.maximum(var_perp, 0.0)), 0.2)
        else:
            std = jnp.full_like(diameter, 0.2)

        offsets = [0.0]
        pds = []
        closes = []
        pd_c, close_c = self._pd_single(pose, xy, diameter)
        pds.append(pd_c)
        closes.append(close_c)
        valid_list = [jnp.ones_like(pd_c, bool)]
        for i in range(1, N_PROBE_PAIRS + 1):
            probe_valid = (i - 1) * 2.0 * diameter < std
            for sgn in (1.0, -1.0):
                off = sgn * i * 2.0 * diameter
                xy_p = xy + off[..., None] * perp
                pd_p, _ = self._pd_single(pose, xy_p, diameter)
                pds.append(jnp.where(probe_valid, pd_p, pd_c))
                valid_list.append(probe_valid)
        pds = jnp.stack(pds, axis=-1)
        pd_max = jnp.max(pds, axis=-1)
        pd_min = jnp.min(pds, axis=-1)
        close = close_c | ((pd_min == 0.0) & (pd_max > 0.0))
        return pd_max, close

    # ------------------------------------------------------------- clutter
    def clutter_intensity(self, z=None, n_z=None):
        return self.clutter_value

    def clutter_intensity_integral(self, n_z=None):
        return self.expected_clutter

    def with_scan(self, scan361: jax.Array):
        """Attach a raw 361-beam scan; computes the per-scan clutter
        intensity from the scan's FoV polygon area (setLaserScan, :267-286)."""
        area = jnp.sum(scan361[1:] * scan361[:-1]) + scan361[0] * scan361[-1]
        area = area * jnp.sin(jnp.pi / 360.0) / 2.0
        scan720 = jnp.zeros((720,)).at[:361].set(scan361)
        return self.replace(
            scan720=scan720,
            clutter_value=self.expected_clutter / jnp.maximum(area, 1e-6),
            has_scan=True,
        )


def fov_area_clutter(expected_clutter, r_min, r_max, b_min, b_max):
    """Constant clutter intensity for the no-scan fallback: expected count
    over the sensing sector area."""
    area = 0.5 * (b_max - b_min) * (r_max**2 - r_min**2)
    return expected_clutter / area
