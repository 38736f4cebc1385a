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


def cs_match(tcs, cs):
    """Does tensor index `tcs` rotate with the basis system `cs`? Equal
    systems do, and so do a spherical system and its embedded
    S2Coordinates, either way round: a sphere basis inside a shell
    problem stores spherical tensor indices as (-, +, 0) spin components
    (dedalus_tpu/core/curvilinear.py:45 _cs_match)."""
    if tcs == cs:
        return True
    sub = getattr(tcs, "S2coordsys", None)
    if sub is not None and sub == cs:
        return True
    sup = getattr(cs, "S2coordsys", None)
    return sup is not None and sup == tcs


def index_blocks(tcs, cs):
    """One tensor index's components as blocks [(system, rotates)] with
    respect to the basis system `cs`: the index whole when it rotates with
    `cs` (cs_match) or is no DirectProduct, else a DirectProduct index
    factor by factor, a factor rotating when it matches `cs`."""
    if cs_match(tcs, cs):
        return [(tcs, True)]
    subs = getattr(tcs, "coordsystems", None)
    if subs is None:
        return [(tcs, False)]
    return [(sub, cs_match(sub, cs)) for sub in subs]


def index_rotates(tcs, cs):
    """Per component of one tensor index: does it rotate with `cs`?"""
    return np.concatenate([np.full(sub.dim, rot)
                           for sub, rot in index_blocks(tcs, cs)])


def entry_spins(tcs, cs):
    """Spin labels of one tensor index's components with respect to `cs`:
    each rotating block's own ordering, zeros elsewhere
    (dedalus_tpu/core/curvilinear.py:30 _entry_spins)."""
    return np.concatenate([
        np.array(sub.spin_ordering) if rot else np.zeros(sub.dim, dtype=int)
        for sub, rot in index_blocks(tcs, cs)])


def component_spins(tensorsig, cs):
    """
    Total spin weight per flattened tensor component, counting only indices
    (or DirectProduct factors) that rotate with `cs` (reference:
    core/basis.py spin_weights).
    """
    spins = np.zeros(1, dtype=int)
    for tcs in tensorsig:
        spins = np.add.outer(spins, entry_spins(tcs, cs)).ravel()
    return spins


def rotating_components(tensorsig, cs):
    """Per flattened tensor component: does any of its indices rotate with
    the basis system `cs` (index_rotates)? A component none of whose
    indices rotates is a real scalar to a polar basis: on a real dtype its
    m = 0 data has the cosine slot only (a cylinder vector's z component),
    where a rotating component's m = 0 pair carries complex spin data."""
    out = np.zeros(1, dtype=bool)
    for tcs in tensorsig:
        out = np.logical_or.outer(out, index_rotates(tcs, cs)).ravel()
    return out


def index_rotation(tcs, cs):
    """The coordinate -> spin map of one tensor index with respect to
    `cs`: block diagonal, U_forward() on each rotating block and the
    identity elsewhere."""
    import scipy.linalg
    return scipy.linalg.block_diag(*[
        sub.U_forward() if rot else np.eye(sub.dim)
        for sub, rot in index_blocks(tcs, cs)])


@functools.lru_cache(maxsize=None)
def recombination_matrix(tensorsig, cs):
    """The complex unitary coordinate -> spin map (ncomp, ncomp) of a
    tensor signature: the kron over tensor indices of index_rotation.
    Cached, so the device copy is made once."""
    U = np.array([[1.0]])
    for tcs in tensorsig:
        U = np.kron(U, index_rotation(tcs, cs))
    return U


@functools.lru_cache(maxsize=None)
def recombination_conj_matrix(tensorsig, cs):
    """U^H of recombination_matrix: the spin -> coordinate map (cached)."""
    return recombination_matrix(tensorsig, cs).conj().T


def real_pair_matrix(C):
    """Real representation of a complex matrix C on (component, pair)
    space: Re(C) (x) I2 + Im(C) (x) J."""
    return np.kron(C.real, np.eye(2)) + np.kron(C.imag, PAIR_J)


@functools.lru_cache(maxsize=None)
def recombination_pair_matrix(tensorsig, cs, backward):
    """The coordinate -> spin map of a tensor signature (`backward`: spin
    -> coordinate, its inverse U^H) in the real (component, pair) form
    Re(U) (x) I2 + Im(U) (x) J. Cached, so the device copy is made
    once."""
    U = recombination_conj_matrix(tensorsig, cs) if backward \
        else recombination_matrix(tensorsig, cs)
    return real_pair_matrix(U)


def apply_recombination(data, tensorsig, cs, tdim, az_axis, complex_dtype,
                        backward):
    """Coordinate -> spin components (`backward`: spin -> coordinate) of
    data with tensor axes [0, tdim) and the azimuth at tdim + az_axis: a
    real dtype applies the (component, pair) form jointly on each
    azimuth pair, a complex dtype the complex map on the components."""
    tensorsig = tuple(tensorsig)
    if not complex_dtype:
        R = recombination_pair_matrix(tensorsig, cs, backward)
        return apply_component_pair_matrix(data, R, tdim, az_axis)
    U = recombination_conj_matrix(tensorsig, cs) if backward \
        else recombination_matrix(tensorsig, cs)
    tshape = data.shape[:tdim]
    ncomp = int(np.prod(tshape, dtype=int)) if tdim else 1
    spatial = data.shape[tdim:]
    flat = data.reshape((ncomp,) + tuple(spatial))
    out = torch.tensordot(match_precision(U, data), flat, dims=([1], [0]))
    return out.reshape(tuple(tshape) + tuple(spatial))


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


def promote_complex(a, b):
    """`a` as complex when `b` is complex and `a` is not (torch's einsum
    takes one dtype, where jnp.einsum promotes)."""
    if b.is_complex() and not a.is_complex():
        return a.to(b.dtype)
    return a


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
    stack = promote_complex(match_precision(stack, data), data)
    data = promote_complex(data, stack)
    G = stack.shape[0]
    d = torch.movedim(data, (axis_groups, axis_target), (-2, -1))
    lead = d.shape[:-2]
    d = d.reshape(tuple(lead) + (G, group_width, d.shape[-1]))
    out = torch.einsum("gji,...gpi->...gpj", stack, d)
    out = out.reshape(tuple(lead) + (G * group_width, out.shape[-1]))
    return torch.movedim(out, (-2, -1), (axis_groups, axis_target))


class SpinBasisMixin:
    """
    Shared machinery for 2D spin-weighted bases (disk, annulus, sphere):
    azimuth (separable, Fourier) x coupled axis with m- and spin-dependent
    matrix stacks (reference: core/basis.py:1561 SpinRecombinationBasis +
    the per-m transform loops in core/transforms.py:1252,1343).

    Concrete bases provide: `cs`, `complex` (a complex dtype),
    `azimuth_basis`, `sub_group_shape(0)`, and either
    `radial_forward_stack(s, scale)` and `radial_backward_stack(s, scale)`
    (G, out, in) stacks over the m groups, or their own `_radial_apply`.
    """

    complex = False

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
            out = apply_recombination(out, tensorsig, self.cs, tdim,
                                      az_axis - tdim, self.complex, False)
        return self._radial_apply(out, tdim, az_axis, axis, spins, scale,
                                  forward=True)

    def backward_transform(self, cdata, axis, scale, library=None,
                           tensorsig=(), sub_axis=0):
        if sub_axis == 0:
            return self.azimuth_basis.backward_transform(cdata, axis, scale,
                                                         library)
        tdim = len(tensorsig)
        az_axis = axis - 1
        spins = component_spins(tensorsig, self.cs)
        out = self._radial_apply(cdata, tdim, az_axis, axis, spins, scale,
                                 forward=False)
        if np.any(spins != 0):
            out = apply_recombination(out, tensorsig, self.cs, tdim,
                                      az_axis - tdim, self.complex, True)
        return out

    def _radial_apply(self, data, tdim, az_axis, r_axis, spins, scale,
                      forward):
        """Coupled-axis transform: per-spin, per-m stacks; a basis whose
        transform is m- and spin-independent (the annulus) overrides this
        with one product."""
        if forward:
            stack_fn = lambda s: self.radial_forward_stack(s, scale)  # noqa: E731
        else:
            stack_fn = lambda s: self.radial_backward_stack(s, scale)  # noqa: E731
        return self._apply_radial_stacks(data, tdim, az_axis, r_axis, spins,
                                         stack_fn)

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
