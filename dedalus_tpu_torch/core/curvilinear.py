"""
Shared curvilinear-basis machinery: spin weights, spin recombination, and
group-batched (per-m) matrix application (counterpart of
dedalus_tpu/core/curvilinear.py; reference: dedalus/core/basis.py:1561
SpinRecombinationBasis, dedalus/libraries/spin_recombination.pyx).

Coefficient-space convention: fields whose tensor signature contains a
curvilinear coordinate system store *spin components* in coefficient
layout; grid layout holds coordinate components. The rotation between them
happens inside the basis transforms (reference: core/basis.py:1595-1663
forward/backward_spin_recombination), as one small dense contraction.

Real-dtype representation: azimuthal coefficients are interleaved
(cos, -sin) pairs; multiplication by i acts on a pair as the rotation
J = [[0, -1], [1, 0]]. A complex matrix C acting on (tensor-component x m)
data therefore becomes the real matrix Re(C) (x) I2 + Im(C) (x) J acting on
(component, pair-slot) jointly.

Host matrices (numpy) are built and cached here, so each is uploaded to
the device once (tools/array.device_constant keys on their identity).
"""

import functools

import numpy as np
import torch

from ..tools.array import match_precision

PAIR_J = np.array([[0.0, -1.0], [1.0, 0.0]])


def component_spins(tensorsig, cs):
    """
    Total spin weight per flattened tensor component, counting only indices
    whose coordinate system is `cs` (reference: core/basis.py spin_weights).
    """
    spins = np.zeros(1, dtype=int)
    for tcs in tensorsig:
        if tcs == cs:
            s = np.array(tcs.spin_ordering)
        else:
            s = np.zeros(tcs.dim, dtype=int)
        spins = np.add.outer(spins, s).ravel()
    return spins


@functools.lru_cache(maxsize=None)
def recombination_pair_matrix(tensorsig, cs, backward):
    """The coordinate -> spin map of a tensor signature (`backward`: spin
    -> coordinate, its inverse U^H) in the real (component, pair) form
    Re(U) (x) I2 + Im(U) (x) J. U is the kron over tensor indices of
    cs.U_forward() (identity on indices of other systems). Cached, so the
    device copy is made once."""
    U = np.array([[1.0]])
    for tcs in tensorsig:
        U = np.kron(U, tcs.U_forward() if tcs == cs else np.eye(tcs.dim))
    if backward:
        U = U.conj().T
    return np.kron(U.real, np.eye(2)) + np.kron(U.imag, PAIR_J)


def apply_component_pair_matrix(data, R, tdim, az_axis):
    """
    Apply a real (component, pair) matrix R (2 ncomp, 2 ncomp) to real data
    with flattened tensor components: R acts jointly on the components and
    the two slots of each azimuthal pair, as one contraction with no loop
    over m.

    data: (*tshape, axes...) with tensor axes [0, tdim) and the azimuth
    axis at tdim + az_axis.
    """
    tshape = data.shape[:tdim]
    ncomp = int(np.prod(tshape, dtype=int)) if tdim else 1
    spatial = data.shape[tdim:]
    R = match_precision(R, data).reshape(ncomp, 2, ncomp, 2)
    a = 1 + az_axis
    flat = data.reshape((ncomp,) + tuple(spatial))
    moved = torch.movedim(flat, a, -1)                 # (ncomp, rest..., Naz)
    rest = moved.shape[1:-1]
    pairs = moved.reshape((ncomp,) + tuple(rest) + (moved.shape[-1] // 2, 2))
    out = torch.einsum("cpdq,d...mq->c...mp", R, pairs)
    out = out.reshape((ncomp,) + tuple(rest) + (moved.shape[-1],))
    out = torch.movedim(out, -1, a)
    return out.reshape(tuple(tshape) + tuple(spatial))


def apply_group_stack(data, stack, axis_groups, axis_target, group_width):
    """
    Apply per-group matrices along a coupled axis: out[..., g, ..., j, ...] =
    stack[g, j, i] * data[..., g, ..., i, ...], where the group index g lives
    on `axis_groups` (packed as G * group_width entries; the width slots
    broadcast) and the matrix is applied along `axis_target`: one batched
    matmul over the m groups (the reference loops per m in Python,
    core/transforms.py:1260-1288; the JAX package's product is an XLA
    einsum outside any Pallas kernel).
    """
    stack = match_precision(stack, data)
    G = stack.shape[0]
    d = torch.movedim(data, (axis_groups, axis_target), (-2, -1))
    lead = d.shape[:-2]
    d = d.reshape(tuple(lead) + (G, group_width, d.shape[-1]))
    out = torch.einsum("gji,...gpi->...gpj", stack, d)
    out = out.reshape(tuple(lead) + (G * group_width, out.shape[-1]))
    return torch.movedim(out, (-2, -1), (axis_groups, axis_target))


class SpinBasisMixin:
    """
    Shared machinery for 2D spin-weighted bases (here the sphere):
    azimuth (separable, Fourier) x coupled axis with m- and spin-dependent
    matrix stacks (reference: core/basis.py:1561 SpinRecombinationBasis +
    the per-m transform loops in core/transforms.py:1252,1343).

    Concrete bases provide: `cs`, `azimuth_basis`, `sub_group_shape(0)`,
    `radial_forward_stack(s, scale)` and `radial_backward_stack(s, scale)`
    (G, out, in) stacks over the m groups.
    """

    def forward_transform(self, gdata, axis, scale, library=None,
                          tensorsig=(), sub_axis=0):
        if sub_axis == 0:
            return self.azimuth_basis.forward_transform(gdata, axis, scale,
                                                        library)
        tdim = len(tensorsig)
        az_axis = axis - 1
        out = gdata
        spins = component_spins(tensorsig, self.cs)
        if np.any(spins != 0):
            R = recombination_pair_matrix(tuple(tensorsig), self.cs, False)
            out = apply_component_pair_matrix(out, R, tdim, az_axis - tdim)
        return self._apply_radial_stacks(
            out, tdim, az_axis, axis, spins,
            lambda s: self.radial_forward_stack(s, scale))

    def backward_transform(self, cdata, axis, scale, library=None,
                           tensorsig=(), sub_axis=0):
        if sub_axis == 0:
            return self.azimuth_basis.backward_transform(cdata, axis, scale,
                                                         library)
        tdim = len(tensorsig)
        az_axis = axis - 1
        spins = component_spins(tensorsig, self.cs)
        out = self._apply_radial_stacks(
            cdata, tdim, az_axis, axis, spins,
            lambda s: self.radial_backward_stack(s, scale))
        if np.any(spins != 0):
            R = recombination_pair_matrix(tuple(tensorsig), self.cs, True)
            out = apply_component_pair_matrix(out, R, tdim, az_axis - tdim)
        return out

    def _apply_radial_stacks(self, data, tdim, az_axis, r_axis, spins,
                             stack_fn):
        """Apply per-spin group stacks along the coupled axis (batched
        over m; one product per distinct spin)."""
        tshape = data.shape[:tdim]
        ncomp = int(np.prod(tshape, dtype=int)) if tdim else 1
        flat = data.reshape((ncomp,) + tuple(data.shape[tdim:]))
        gs = self.sub_group_shape(0)
        pieces = [None] * ncomp
        for s in np.unique(spins):
            idx = np.flatnonzero(spins == s)
            # component slices, not an index tensor: an index made on the
            # host would be a host-to-device copy in every transform
            if idx[-1] - idx[0] + 1 == len(idx):
                sub = flat[idx[0]:idx[-1] + 1]
            else:
                sub = torch.stack([flat[i] for i in idx])
            sub = apply_group_stack(sub, stack_fn(int(s)), 1 + az_axis - tdim,
                                    1 + r_axis - tdim, gs)
            for j, i in enumerate(idx):
                pieces[i] = sub[j]
        out = torch.stack(pieces, dim=0)
        return out.reshape(tuple(tshape) + tuple(out.shape[1:]))
