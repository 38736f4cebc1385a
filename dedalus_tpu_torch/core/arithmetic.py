"""
Arithmetic expression nodes (counterpart of dedalus_tpu/core/arithmetic.py:
the Cartesian products, the angularly constant polar NCCs, and the
spherical NCCs of the shell, the ball and the sphere): Add, ScalarMultiply,
MultiplyFields, DotProduct, CrossProduct, Power.

Grid-space products are pointwise torch ops; LHS products with a
non-constant-coefficient (NCC) factor assemble multiplication matrices by
quadrature (tools.jacobi.multiplication_matrix; the annulus's
radial_multiplication_matrix; the disk's per-(m, spin) Zernike stacks; the
shell's and the ball's per-(ell, regularity) radial matrices for radial
profiles and SWSH triple-product couplings for colatitude-varying ones,
per (ell', ell) pair on the ball, whose Zernike spaces depend on ell); a
constant NCC factor (e.g. the unit vector in `b*ez`) becomes a
tensor-placement factor times a scalar. NCCs that vary with the azimuth of a disk or
annulus couple the m groups and are not carried yet: they raise
NotImplementedError.
"""

import numpy as np
import scipy.sparse as sp
import torch

from .field import Field
from .future import Future, ev
from .domain import Domain
from .basis import Jacobi
from ..tools.array import kron as sparse_kron, sparsify
from ..tools.exceptions import NonlinearOperatorError
from ..tools.general import is_complex_dtype

from .operators import operand_expression_matrices, ConvertNode
from .curvilinear import PAIR_J, component_spins


def _is_scalar(x):
    return np.isscalar(x) or (isinstance(x, np.ndarray) and x.ndim == 0)


def _max_basis(bases):
    out = None
    for b in bases:
        if b is None:
            continue
        if out is None:
            out = b
        elif isinstance(out, Jacobi) and isinstance(b, Jacobi):
            if (out.a0, out.b0, out.size, out.bounds) != (b.a0, b.b0, b.size, b.bounds):
                raise ValueError(f"Incompatible Jacobi bases: {out} vs {b}")
            if b.k > out.k:
                out = b
        elif type(out) is type(b) and hasattr(out, "family_key"):
            # two-axis bases of one family (disk, annulus) at two k levels
            if out.family_key != b.family_key:
                raise ValueError(f"Incompatible bases: {out} vs {b}")
            if getattr(b, "k", 0) > getattr(out, "k", 0):
                out = b
        elif out != b:
            raise ValueError(f"Incompatible bases along axis: {out} vs {b}")
    return out


def _union_domain(dist, operands):
    dim = dist.dim
    bases = []
    for axis in range(dim):
        axis_bases = [op.domain.bases[axis] for op in operands
                      if isinstance(op, (Field, Future))]
        bases.append(_max_basis(axis_bases))
    return Domain(dist, tuple(bases))


def _product_domain(dist, operands):
    """
    Output domain of a product. On a coupled (Jacobi) axis where BOTH
    operands carry a basis, a true multiplication happens and the output
    lives at BASE derivative level — matching the NCC matrices
    (multiplication_matrix with dk_out=-k in ProductBase._ncc_axis_matrices).
    Where only one operand has the axis basis, the other is a scalar factor
    along that axis and the derivative level survives.
    """
    ops = [op for op in operands if isinstance(op, (Field, Future))]
    bases = []
    for axis in range(dist.dim):
        axis_bases = [op.domain.bases[axis] for op in ops
                      if op.domain.bases[axis] is not None]
        merged = _max_basis(axis_bases)
        if len(axis_bases) > 1 and isinstance(merged, Jacobi):
            merged = merged.base_basis()
        elif len(axis_bases) > 1 and getattr(merged, "k", 0) \
                and hasattr(merged, "clone_with"):
            merged = merged.clone_with(k=0)
        bases.append(merged)
    return Domain(dist, tuple(bases))


def _promote_dtype(operands):
    dtypes = [op.dtype for op in operands if isinstance(op, (Field, Future))]
    dtypes += [np.asarray(op).dtype for op in operands if _is_scalar(op)]
    return np.result_type(*dtypes)


class Add(Future):
    """Addition (reference: core/arithmetic.py:50)."""

    name = "Add"
    natural_layout = "g"

    def __init__(self, *args):
        flat = []
        for a in args:
            if isinstance(a, Add):
                flat.extend(a.args)
            else:
                flat.append(a)
        super().__init__(*flat)

    def _build_metadata(self):
        operands = [a for a in self.args if isinstance(a, (Field, Future))]
        tensorsigs = {tuple(op.tensorsig) for op in operands}
        if len(tensorsigs) != 1:
            raise ValueError("Cannot add operands with different tensor signatures.")
        if any(_is_scalar(a) for a in self.args) and next(iter(tensorsigs)):
            raise ValueError("Cannot add scalars to tensor fields.")
        self.tensorsig = next(iter(tensorsigs))
        self.domain = _union_domain(self.dist, operands)
        self.dtype = _promote_dtype(self.args)

    def ev_impl(self, ctx):
        total = None
        for a in self.args:
            data = ev(a, ctx, "g") if isinstance(a, (Field, Future)) else a
            total = data if total is None else total + data
        return total

    def expression_matrices(self, subproblem, vars, **kw):
        out = {}
        for a in self.args:
            if _is_scalar(a):
                if a != 0:
                    raise NonlinearOperatorError("Nonzero constant on equation LHS.")
                continue
            term = a if tuple(a.domain.bases) == self.domain.bases else \
                ConvertNode(a, self.domain.bases)
            mats = operand_expression_matrices(term, subproblem, vars, **kw)
            for var, mat in mats.items():
                out[var] = out.get(var) + mat if var in out else mat
        return out

    def frechet_differential(self, variables, perturbations):
        # d(a + b) = da + db: the multilinear rule of Future would keep
        # the undifferentiated siblings
        out = 0
        for a in self.args:
            if isinstance(a, (Field, Future)):
                d = a.frechet_differential(variables, perturbations)
                if not (_is_scalar(d) and d == 0):
                    out = out + d
        return out


class ScalarMultiply(Future):
    """Multiplication by a scalar constant: linear, layout-agnostic."""

    name = "ScalarMul"

    def __init__(self, scalar, operand):
        self.scalar = scalar
        super().__init__(operand)

    def rebuild(self, new_args):
        return ScalarMultiply(self.scalar, new_args[0])

    @property
    def operand(self):
        return self.args[0]

    def _build_metadata(self):
        operand = self.args[0]
        self.domain = operand.domain
        self.tensorsig = operand.tensorsig
        self.dtype = np.result_type(operand.dtype, np.asarray(self.scalar).dtype)

    def __repr__(self):
        return f"({self.scalar}*{self.args[0]})"

    def ev(self, ctx, layout):
        key = (id(self), layout)
        if key in ctx.memo:
            return ctx.memo[key]
        out = self.scalar * ev(self.operand, ctx, layout)
        ctx.memo[key] = out
        return out

    def expression_matrices(self, subproblem, vars, **kw):
        mats = operand_expression_matrices(self.operand, subproblem, vars, **kw)
        return {var: self.scalar * mat for var, mat in mats.items()}

    def frechet_differential(self, variables, perturbations):
        d = self.operand.frechet_differential(variables, perturbations)
        if _is_scalar(d) and d == 0:
            return 0
        return ScalarMultiply(self.scalar, d)


def Multiply(a, b):
    """Multiplication factory (reference: core/arithmetic.py:257 Product)."""
    if _is_scalar(a) and _is_scalar(b):
        return a * b
    if _is_scalar(a):
        if a == 0:
            return 0
        if a == 1:
            return b
        return ScalarMultiply(a, b)
    if _is_scalar(b):
        if b == 0:
            return 0
        if b == 1:
            return a
        return ScalarMultiply(b, a)
    return MultiplyFields(a, b)


def _filter_rel(mat, rel):
    """Drop entries of a sparse matrix below rel * max|entry|, REAL and
    IMAGINARY parts independently: source-precision residue often rides
    as a tiny real part on a large purely-imaginary coupling (or vice
    versa), and the azimuthal pair representation would otherwise spread
    it into spurious cross-pair couplings. (sparsify() passes sparse
    inputs through untouched, so totals need this explicit filter.)"""
    mat = mat.tocoo()
    if mat.nnz == 0:
        return mat.tocsr()
    cut = rel * np.abs(mat.data).max()
    if np.iscomplexobj(mat.data):
        re = np.where(np.abs(mat.data.real) >= cut, mat.data.real, 0.0)
        im = np.where(np.abs(mat.data.imag) >= cut, mat.data.imag, 0.0)
        data = re + 1j * im
    else:
        data = np.where(np.abs(mat.data) >= cut, mat.data, 0.0)
    keep = data != 0
    return sp.csr_matrix((data[keep], (mat.row[keep], mat.col[keep])),
                         shape=mat.shape)


def _interleave_gs(M, nout, nin, gs, X):
    """
    Lift a matrix over (component x X) index spaces to (component x gs x X)
    on the gs (azimuthal cos/sin pair) axis, matching the slot ordering
    component-major > pair > coupled axes. A real matrix acts identically
    on both pair slots (kron with I2); a complex matrix acts through its
    real 2x2 pair representation Re (x) I2 + Im (x) J — the same
    convention the transforms use for the spin recombination
    (curvilinear.real_pair_matrix).
    """
    if np.iscomplexobj(M.data if sp.issparse(M) else M):
        Mr = M.real
        Mi = M.imag
        K = (sp.kron(Mr, sp.identity(gs), format="csr")
             + sp.kron(Mi, sp.csr_matrix(PAIR_J), format="csr"))
    else:
        K = sp.kron(M, sp.identity(gs), format="csr")  # ordering (comp, X, j)

    def perm(ncomp):
        comp = np.repeat(np.arange(ncomp), gs * X)
        j = np.tile(np.repeat(np.arange(gs), X), ncomp)
        x = np.tile(np.arange(X), ncomp * gs)
        return comp * (X * gs) + x * gs + j

    return K[perm(nout)][:, perm(nin)]


def _scratch_copy(field):
    """A new field holding a copy of `field`'s coefficients, to read
    at other scales or in grid space without touching `field`."""
    work = field.dist.Field(bases=field.domain.bases,
                            tensorsig=field.tensorsig, dtype=field.dtype)
    work["c"] = np.array(field["c"])
    return work


class ProductBase(Future):
    """Shared NCC machinery for Multiply/Dot: grid-space products that become
    linear matrices when one side has no problem variables."""

    natural_layout = "g"

    def _split_ncc(self, vars, layout=None):
        """Return (ncc_side_index, ncc_field, operand_expr)."""

        def contains_vars(x):
            if _is_scalar(x):
                return False
            if isinstance(x, Field):
                return x in vars
            return x.has(*vars)

        has = [contains_vars(a) for a in self.args]
        if all(has):
            raise NonlinearOperatorError(
                f"Nonlinear term on LHS: {self!r} has variables on both sides.")
        if not any(has):
            raise NonlinearOperatorError(f"LHS term {self!r} contains no variables.")
        op_index = has.index(True)
        ncc_index = 1 - op_index
        ncc = self.args[ncc_index]
        if not isinstance(ncc, Field):
            ncc = ncc.evaluate()
        # NCCs must be constant along axes the LAYOUT keeps separable for
        # group-diagonality; axes the layout coupled (forced by this very
        # NCC, see subsystems._ncc_forced_coupled_axes) build full
        # multiplication matrices instead. Without layout context, fall
        # back to the conservative basis-level check.
        for axis, basis in enumerate(ncc.domain.bases):
            if basis is None or basis.dim != 1:
                # two-axis (polar) NCC bases check their angular
                # constancy in their own assembly paths
                continue
            separable = (axis in layout.sep_widths) if layout is not None \
                else basis.separable
            if separable:
                raise NonlinearOperatorError(
                    "LHS coefficient fields must be constant along separable axes.")
        return ncc_index, ncc, self.args[op_index]

    def _ncc_axis_terms(self, ncc, comp_index, operand):
        """
        [(scalar, descrs)] kron terms multiplying by ncc component
        `comp_index` (dedalus_tpu/core/arithmetic.py:307). A constant NCC
        is a scalar multiplier; an NCC varying along one Jacobi or
        Fourier axis builds that axis's multiplication matrix; an
        angularly constant annulus NCC its radial multiplication matrix.
        An NCC varying JOINTLY along several 1-D axes (a 2-D background
        U(x, z)) expands modally along its first varying axis, one kron
        term per significant mode (`_ncc_axis_terms_from`); an
        azimuthally varying annulus NCC expands per azimuth mode onto the
        m-coupled pencil (`_polar_coupled_azimuth_terms`). A term's
        scalar may be a component-mixing matrix (the real-pair expansion
        of the latter).
        """
        bases = list(ncc.domain.bases)
        if ncc.tensorsig and any(
                b is not None and b.dim > 1
                and hasattr(b, "radial_multiplication_matrix")
                for b in bases):
            raise NonlinearOperatorError(
                "Tensor-valued NCCs on curvilinear bases route through the "
                "spin assembly paths, not the per-axis path.")
        ccomp = np.asarray(ncc["c"])[comp_index]  # host transform of NCC data
        # the classifier that forced the layout's m-coupling
        # (subsystems._ncc_forced_coupled_axes) decides the route, read
        # off a scratch copy (a grid read of the NCC itself would move
        # its data through the transforms once per group)
        for ax0, nb in enumerate(bases):
            if (nb is not None and nb.dim == 2
                    and hasattr(nb, "radial_multiplication_matrix")
                    and hasattr(nb, "azimuth_basis")
                    and ax0 == nb.first_axis
                    and ProductBase.polar_azimuth_varies(_scratch_copy(ncc),
                                                         nb)):
                return self._polar_coupled_azimuth_terms(
                    ccomp, bases, operand, ax0)
        return self._ncc_axis_terms_from(ccomp, bases, operand)

    def _ncc_axis_terms_from(self, ccomp, bases, operand):
        """The modal expansion of `_ncc_axis_terms` over an explicit
        coefficient array and per-axis basis list
        (dedalus_tpu/core/arithmetic.py:345): exact by the linearity of
        the multiplication matrices in the NCC coefficients, one kron
        term per mode j of the first varying 1-D axis whose slice is
        significant, recursing on the slice."""
        one_d = [ax for ax in range(self.dist.dim)
                 if bases[ax] is not None and bases[ax].dim == 1
                 and ccomp.shape[ax] > 1]
        if len(one_d) < 2:
            return [self._ncc_axis_matrices_from(ccomp, bases, operand)]
        a1 = one_d[0]
        nb = bases[a1]
        ob = operand.domain.bases[a1]
        n1 = ccomp.shape[a1]
        tol = self._ncc_data_cutoff(ccomp) * max(np.abs(ccomp).max(), 1e-300)
        sub_bases = list(bases)
        sub_bases[a1] = None
        terms = []
        for j in range(n1):
            slice_j = np.take(ccomp, [j], axis=a1)
            if np.abs(slice_j).max() <= tol:
                continue
            e_j = np.zeros(n1)
            e_j[j] = 1.0
            if ob is None:
                descr_j = ("full", sparsify(e_j.reshape(-1, 1), 1e-13))
            elif isinstance(nb, Jacobi):
                descr_j = ("full", sparsify(
                    ob.multiplication_matrix(e_j, nb, dk_out=-ob.k), 1e-13))
            elif hasattr(nb, "multiplication_matrix") and nb.separable:
                descr_j = ("full", sparsify(
                    ob.multiplication_matrix(e_j, nb), 1e-13))
            else:
                raise NonlinearOperatorError(
                    f"LHS NCCs may not vary along basis {nb!r}.")
            for scalar, descrs in self._ncc_axis_terms_from(
                    slice_j, sub_bases, operand):
                descrs = list(descrs)
                descrs[a1] = descr_j
                terms.append((scalar, descrs))
        return terms

    def _polar_coupled_azimuth_terms(self, ccomp, bases, operand, ax0):
        """Kron terms of an azimuthally varying annulus NCC (scalar data;
        dedalus_tpu/core/arithmetic.py:385): one term per significant
        azimuth mode j,

            (azimuth convolution of mode j) kron (radial mult of f_j(r)),

        on the layout-coupled azimuth axis (whole-axis convolution
        matrices). The annulus radial space is m-independent, so the
        radial factor is one multiplication matrix per mode.

        Real-dtype TENSOR operands store spin-recombined (cos, -sin)
        pairs, and the recombination does not commute with the azimuth
        convolution: the coordinate-component convolution is conjugated
        by the stored recombination W = Re(U) (x) I2 + Im(U) (x) J, which
        expands each mode's term into at most four kron terms with
        component-mixing tensor factors:
            W_out (I_c (x) A (x) R) W_in^dagger
              =   Re(Uo)Re(Ui)^T (x) A        (x) R
                - Re(Uo)Im(Ui)^T (x) A Jz_in  (x) R
                + Im(Uo)Re(Ui)^T (x) Jz_out A (x) R
                - Im(Uo)Im(Ui)^T (x) Jz_out A Jz_in (x) R
        with Jz = I_groups (x) PAIR_J on the interleaved azimuth axis.
        Scalar operands (U = 1) reduce to the single real term; complex
        dtypes keep the spin-diagonal convolution."""
        nb = bases[ax0]
        r_axis = ax0 + 1
        ob_pol = operand.domain.bases[ax0]
        if ob_pol is None or not hasattr(ob_pol, "azimuth_basis"):
            raise NonlinearOperatorError(
                "Azimuthally-varying polar NCCs require the operand on a "
                "polar basis too.")
        real_tensor = bool(operand.tensorsig) \
            and not is_complex_dtype(operand.dtype)
        mixers = [(None, 0, 0)]
        if real_tensor:
            from .curvilinear import recombination_matrix
            cs = nb.cs
            Uo = recombination_matrix(tuple(self.tensorsig), cs)
            Ui = recombination_matrix(tuple(operand.tensorsig), cs)
            mixers = [
                (Uo.real @ Ui.real.T, 0, 0),
                (-(Uo.real @ Ui.imag.T), 0, 1),
                (Uo.imag @ Ui.real.T, 1, 0),
                (-(Uo.imag @ Ui.imag.T), 1, 1),
            ]
        moved = np.moveaxis(ccomp, (ax0, r_axis), (0, 1))
        if moved.size != moved.shape[0] * moved.shape[1]:
            raise NonlinearOperatorError(
                "Azimuthally-varying polar NCCs may not vary along "
                "additional axes.")
        az_r = moved.reshape(moved.shape[0], moved.shape[1])
        tol = self._ncc_data_cutoff(az_r) * max(np.abs(az_r).max(), 1e-300)
        dim = self.dist.dim
        terms = []
        for j in range(az_r.shape[0]):
            prof = az_r[j]
            if np.abs(prof).max() <= tol:
                continue
            e_j = np.zeros(ccomp.shape[ax0], dtype=az_r.dtype)
            e_j[j] = 1.0
            A = sp.csr_matrix(ob_pol.azimuth_basis.multiplication_matrix(
                e_j, nb.azimuth_basis))
            R = sparsify(ob_pol.radial_multiplication_matrix(prof, nb.k,
                                                             k_out=0),
                         self._ncc_sparsify_cutoff(prof))
            for mix, left_j, right_j in mixers:
                if mix is not None and np.abs(mix).max() < 1e-14:
                    continue
                Ax = A
                if right_j:
                    Ax = Ax @ sp.kron(sp.identity(A.shape[1] // 2), PAIR_J,
                                      format="csr")
                if left_j:
                    Ax = sp.kron(sp.identity(A.shape[0] // 2), PAIR_J,
                                 format="csr") @ Ax
                descrs = [None] * dim
                descrs[ax0] = ("full", sparsify(Ax, 1e-14))
                descrs[r_axis] = ("full", R)
                terms.append((mix, descrs))
        if not terms:
            descrs = [None] * dim
            descrs[ax0] = ("full", sp.csr_matrix(
                (ccomp.shape[ax0], ccomp.shape[ax0])))
            terms.append((None, descrs))
        return terms

    def _ncc_axis_matrices_from(self, ccomp, ncc_bases, operand):
        """Per-axis matrices for a single-varying-axis coefficient array
        (`ncc_bases`: the NCC's per-axis basis list, None = constant)."""
        descrs = []
        axis = 0
        while axis < self.dist.dim:
            nb = ncc_bases[axis]
            ob = operand.domain.bases[axis]
            if nb is None:
                descrs.append(None)  # constant along axis: scalar handled below
                axis += 1
            elif isinstance(nb, Jacobi):
                # collapse other axes of the coefficient array
                # one varying axis: `_ncc_axis_terms_from` expands a
                # joint NCC modally before it gets here
                ax_coeffs = np.moveaxis(ccomp, axis, -1)
                cut = self._ncc_sparsify_cutoff(ax_coeffs)
                if ob is None:
                    # operand constant along axis: column embedding the NCC
                    descrs.append(("full", sparsify(ax_coeffs.reshape(-1, 1),
                                                    cut)))
                else:
                    M = ob.multiplication_matrix(ax_coeffs.ravel(), nb, dk_out=-ob.k)
                    descrs.append(("full", sparsify(M, cut)))
                axis += 1
            elif nb.dim == 2 and hasattr(nb, "radial_multiplication_matrix"):
                # angularly constant annulus NCC: identity on the azimuth
                # (m=0 data only), a radial multiplication matrix on the
                # radius (dedalus_tpu/core/arithmetic.py:507)
                r_axis = axis + 1
                moved = np.moveaxis(ccomp, r_axis, -1)
                tol = 1e-10 * max(np.abs(ccomp).max(), 1e-300)
                non_const = moved.reshape(-1, moved.shape[-1])[1:]
                if non_const.size and np.abs(non_const).max() > tol:
                    raise NonlinearOperatorError(
                        "LHS coefficient fields on curvilinear bases must be "
                        "angularly constant (lowest angular mode only).")
                radial_coeffs = moved.reshape(-1, moved.shape[-1])[0]
                if ob is None:
                    raise NonlinearOperatorError(
                        "Embedding a curvilinear NCC into a constant operand "
                        "is not supported yet.")
                M = ob.radial_multiplication_matrix(radial_coeffs, nb.k,
                                                    k_out=0)
                descrs.append(None)  # azimuth identity
                descrs.append(("full", sparsify(
                    M, self._ncc_sparsify_cutoff(radial_coeffs))))
                axis += 2
            elif hasattr(nb, "multiplication_matrix") and nb.separable:
                # a Fourier NCC on a periodic axis the layout coupled: the
                # whole axis's convolution matrix
                # (dedalus_tpu/core/arithmetic.py:532)
                ax_coeffs = np.moveaxis(ccomp, axis, -1)
                cut = self._ncc_sparsify_cutoff(ax_coeffs)
                if ob is None:
                    descrs.append(("full", sparsify(ax_coeffs.reshape(-1, 1),
                                                    cut)))
                else:
                    M = ob.multiplication_matrix(ax_coeffs.ravel(), nb)
                    descrs.append(("full", sparsify(M, cut)))
                axis += 1
            else:
                raise NonlinearOperatorError(
                    f"LHS NCCs may not vary along basis {nb!r}.")
        # fully-constant NCC: scalar multiplier
        if all(d is None for d in descrs):
            value = ccomp.ravel()[0]
            return (complex(value) if np.iscomplexobj(ccomp)
                    else float(value)), descrs
        return None, descrs

    def _polar_spin_basis(self, operand):
        """The disk or annulus basis of `operand`, or None."""
        from .polar import DiskBasis, AnnulusBasis
        for b in operand.domain.bases:
            if isinstance(b, (DiskBasis, AnnulusBasis)):
                return b
        return None

    def _spherical_regularity_basis(self, operand):
        """The shell basis of `operand` (regularity components), or
        None."""
        for b in operand.domain.bases:
            if b is not None and getattr(b, "regularity", False):
                return b
        return None

    def _s2_basis(self, operand):
        """The sphere basis of `operand`, or None."""
        from .sphere import SphereBasis
        for b in operand.domain.bases:
            if isinstance(b, SphereBasis):
                return b
        return None

    def _disk_ncc_matrix(self, subproblem, ncc, operand, place_fn):
        """
        Pencil matrix of an angularly constant NCC on the DISK, scalar or
        tensor valued (dedalus_tpu/core/arithmetic.py:579). Zernike radial
        spaces are (m, spin)-dependent, so each coordinate component c of
        the NCC contributes per-m radial stacks bracketed by the spin
        coupling C = U_out P_c U_in^H:

            term(c, i, j) = C_ij * F_out(s_i)[m] diag(f_c) B_in(s_j)[m]

        assembled through ("gblocks", az, stack) descriptors. Profiles are
        sampled on the 2x radial quadrature grid through the field's own
        transforms. `place_fn(c)` gives the coordinate-space component
        placement (outer product or contraction).
        """
        from .curvilinear import recombination_matrix
        from .operators import assemble_group_matrix
        nb = self._polar_spin_basis(ncc)
        ob = self._polar_spin_basis(operand)
        if ob is None:
            raise NonlinearOperatorError(
                "Disk NCCs require the operand on the disk basis too.")
        cs = nb.cs
        az_axis = nb.first_axis
        r_axis = az_axis + 1
        dim = self.dist.dim
        # profiles on the 2x quadrature grid, via the field's transforms
        # on a scratch copy of its coefficients: reading the NCC itself at
        # scale 2 and back would round-trip its data through coefficient
        # space once per group, drifting it by ~1e-13 relative a call
        # (the JAX package's _disk_ncc_matrix does, :606-609)
        work = _scratch_copy(ncc)
        work.change_scales(2)
        grid = np.asarray(work["g"])
        tdim_n = len(ncc.tensorsig)
        ncomp_n = int(np.prod(ncc.tshape, dtype=int)) if ncc.tshape else 1
        flat = grid.reshape((ncomp_n,) + grid.shape[tdim_n:])
        tol = 1e-10 * max(np.abs(flat).max(), 1e-300)
        moved = np.moveaxis(flat, 1 + az_axis, 1)
        if ProductBase.polar_azimuth_varies(work, nb):
            # azimuthally varying by the classifier that forced the
            # layout's m-coupling (subsystems._ncc_forced_coupled_axes),
            # read off the scratch copy: cross-m assembly onto the
            # coupled pencil
            if subproblem.group[az_axis] is not None:
                raise NonlinearOperatorError(
                    "Azimuthally-varying disk NCC reached a per-m pencil; "
                    "the layout classifier should have coupled azimuth.")
            return self._disk_coupled_ncc_matrix(ncc, operand, moved)
        if np.abs(moved - moved[:, :1]).max() > tol:
            raise NonlinearOperatorError(
                "LHS NCCs on disk bases must be angularly constant "
                "(sub-classifier azimuthal content at the data's own "
                "precision is treated as roundoff).")
        profiles = moved[:, 0].reshape(ncomp_n, -1)   # (ncomp_n, Ngr2)
        U_in = recombination_matrix(tuple(operand.tensorsig), cs)
        U_out = recombination_matrix(tuple(self.tensorsig), cs)
        s_in = component_spins(tuple(operand.tensorsig), cs)
        s_out = component_spins(tuple(self.tensorsig), cs)
        real = not is_complex_dtype(self.dtype)
        out_basis = self.domain.bases[az_axis]
        terms = []
        nonzero = [c for c in range(ncomp_n)
                   if np.abs(profiles[c]).max() > tol]
        for c in (nonzero or [0]):
            prof = profiles[c]
            C = U_out @ place_fn(c) @ U_in.conj().T
            for i in range(C.shape[0]):
                for j in range(C.shape[1]):
                    if abs(C[i, j]) < 1e-14 and nonzero:
                        continue
                    F = out_basis.radial_forward_stack(int(s_out[i]), 2.0)
                    B = ob.radial_backward_stack(int(s_in[j]), 2.0)
                    stack = np.einsum("gnr,r,grk->gnk", F, prof, B)
                    E = np.zeros((C.shape[0], C.shape[1]))
                    E[i, j] = 1.0
                    descrs = [None] * dim
                    if real:
                        az2 = (np.eye(2) * C[i, j].real
                               + PAIR_J * C[i, j].imag)
                        descrs[az_axis] = ("full", sparsify(az2, 1e-14))
                    else:
                        descrs[az_axis] = ("full", sp.csr_matrix(
                            np.array([[C[i, j]]])))
                    descrs[r_axis] = ("gblocks", az_axis, stack)
                    terms.append((E, descrs))
        return assemble_group_matrix(terms, operand.domain, operand.tshape,
                                     self.tshape, subproblem)

    def _disk_coupled_ncc_matrix(self, ncc, operand, moved):
        """
        The m-coupled pencil matrix of an azimuthally varying DISK NCC
        (scalar data; dedalus_tpu/core/arithmetic.py:667). `moved` holds
        the NCC's 2x-quadrature grid data, azimuth leading. The NCC
        expands into azimuth modes j with radial profiles f_j(r); each
        mode contributes, per operand spin component s,

            A_j[slots(m_out), slots(m_in)] (x) F_s[m_out] diag(f_j) B_s[m_in]

        with A_j the whole-axis azimuth convolution of basis mode j and
        F/B the per-m Zernike quadrature stacks (the radial spaces are
        m-dependent, so every coupled (m_out, m_in) pair gets its own
        radial block). Real-dtype TENSOR operands take the stored-pair
        conjugation of `_polar_coupled_azimuth_terms`: each 2x2 azimuth
        pair block az2 carries C1 az2 + C2 az2 J + C3 J az2 + C4 J az2 J,
        Ck the Re/Im products of the spin recombinations.
        """
        from .curvilinear import recombination_matrix
        nb = self._polar_spin_basis(ncc)
        ob = self._polar_spin_basis(operand)
        if ncc.tensorsig:
            raise NonlinearOperatorError(
                "Azimuthally-varying disk NCCs must be scalar fields; "
                "move tensor-valued azimuthal backgrounds to the RHS.")
        real = not is_complex_dtype(self.dtype)
        out_basis = self.domain.bases[nb.first_axis]
        prof = moved[0].reshape(moved.shape[1], -1)       # (Ng_az, Ngr)
        # azimuth-mode expansion through the NCC basis's own forward MMT
        Af = np.asarray(nb.azimuth_basis._mult_forward_matrix(prof.shape[0]))
        modes = Af @ prof                                  # (Naz_ncc, Ngr)
        tol = (self._ncc_data_cutoff(modes)
               * max(np.abs(modes).max(), 1e-300))
        gs = ob.sub_group_shape(0)
        G = ob.sub_n_groups(0)
        Nr = ob.Nr
        cs = ob.cs
        s_in = component_spins(tuple(operand.tensorsig), cs) \
            if operand.tensorsig else np.zeros(1, dtype=int)
        ncomp = len(s_in)
        naz = G * gs
        # azimuth convolutions are spin-independent: one per mode
        conv = []                                    # [(j, A_j)]
        for j in range(modes.shape[0]):
            if np.abs(modes[j]).max() <= tol:
                continue
            e_j = np.zeros(nb.shape[0])
            e_j[j] = 1.0
            A_j = ob.azimuth_basis.multiplication_matrix(
                e_j, nb.azimuth_basis)
            conv.append((j, np.asarray(
                A_j.todense() if sp.issparse(A_j) else A_j)))

        def pair_blocks(A_j, K_of, Fs, Bs, out):
            """out += sum over (m_out, m_in) of kron(K, F[m_out] diag(f_j)
            B[m_in]), K = K_of(the 2x2 or 1x1 azimuth block)."""
            for go in range(G):
                Rrow = None
                for gi in range(G):
                    K = K_of(A_j[go * gs:(go + 1) * gs,
                                 gi * gs:(gi + 1) * gs])
                    if np.abs(K).max() < 1e-14:
                        continue
                    if Rrow is None:
                        Rrow = Fs[go] * prof_j[None, :]
                    out[go * gs * Nr:(go + 1) * gs * Nr,
                        gi * gs * Nr:(gi + 1) * gs * Nr] += np.kron(
                            K, Rrow @ Bs[gi])

        if real:
            Uo = recombination_matrix(tuple(self.tensorsig), cs)
            Ui = recombination_matrix(tuple(operand.tensorsig), cs)
            s_out = component_spins(tuple(self.tensorsig), cs) \
                if self.tensorsig else np.zeros(1, dtype=int)
            Cs = [Uo.real @ Ui.real.T, -(Uo.real @ Ui.imag.T),
                  Uo.imag @ Ui.real.T, -(Uo.imag @ Ui.imag.T)]
            J = PAIR_J
            F = {int(s): np.asarray(out_basis.radial_forward_stack(int(s),
                                                                   2.0))
                 for s in set(int(v) for v in s_out)}
            B = {int(s): np.asarray(ob.radial_backward_stack(int(s), 2.0))
                 for s in set(int(v) for v in s_in)}
            M = np.zeros((len(s_out) * naz * Nr, ncomp * naz * Nr))
            for j, A_j in conv:
                prof_j = modes[j]
                for ci in range(len(s_out)):
                    for cj in range(ncomp):
                        c = [Ck[ci, cj] for Ck in Cs]
                        if max(abs(v) for v in c) < 1e-14:
                            continue
                        pair_blocks(
                            A_j,
                            lambda az2: (c[0] * az2 + c[1] * (az2 @ J)
                                         + c[2] * (J @ az2)
                                         + c[3] * (J @ az2 @ J)),
                            F[int(s_out[ci])], B[int(s_in[cj])],
                            M[ci * naz * Nr:(ci + 1) * naz * Nr,
                              cj * naz * Nr:(cj + 1) * naz * Nr])
            return sp.csr_matrix(sparsify(M, 1e-14))
        spin_mats = {}
        for s in sorted(set(int(v) for v in s_in)):
            F = np.asarray(out_basis.radial_forward_stack(s, 2.0))
            B = np.asarray(ob.radial_backward_stack(s, 2.0))
            M = np.zeros((naz * Nr, naz * Nr), dtype=complex)
            for j, A_j in conv:
                prof_j = modes[j]
                pair_blocks(A_j, lambda az2: az2, F, B, M)
            spin_mats[s] = sparsify(M, 1e-14)
        # a scalar NCC is component-diagonal: block diagonal over them
        return sp.csr_matrix(sp.block_diag(
            [spin_mats[int(s_in[c])] for c in range(ncomp)], format="csr"))

    def _polar_tensor_ncc_matrix(self, subproblem, ncc, operand, ncc_index):
        """
        Pencil matrix of a tensor-valued, angularly constant annulus NCC
        (e.g. the centrifugal-convection example's radial-vector gravity
        b*g; dedalus_tpu/core/arithmetic.py:799). The polar spin
        recombination U is m-independent, so each NCC COORDINATE component
        c with radial profile f_c(r) contributes
            (U_out P_c U_in^H)  (x)  angular-identity  (x)  RadialMult(f_c)
        with P_c placing component c in the coordinate component space.
        Real dtypes apply the complex component coupling jointly on the
        interleaved (cos, -sin) azimuth pair (real_pair_matrix).
        """
        from .curvilinear import recombination_matrix, real_pair_matrix
        from .operators import _axis_identity
        nb = self._polar_spin_basis(ncc)
        ob = self._polar_spin_basis(operand)
        if ob is None or not hasattr(ob, "radial_multiplication_matrix"):
            raise NonlinearOperatorError(
                "Tensor-valued polar NCCs require annulus bases on both "
                "factors (disk regularity spaces are not supported yet).")
        cs = nb.cs
        az_axis = nb.first_axis
        r_axis = az_axis + 1
        # angular constancy check on coordinate-component grid data, read
        # at scale 1 to match the radial forward matrix below
        old_scales = ncc.scales
        ncc.change_scales(1)
        grid = np.asarray(ncc["g"])
        ncc.change_scales(old_scales)
        ncomp_n = int(np.prod(ncc.tshape, dtype=int)) if ncc.tshape else 1
        flat = grid.reshape((ncomp_n,) + grid.shape[len(ncc.tshape):])
        tol = 1e-10 * max(np.abs(flat).max(), 1e-300)
        moved = np.moveaxis(flat, 1 + az_axis, 1)
        if np.abs(moved - moved[:, :1]).max() > tol:
            raise NonlinearOperatorError(
                "LHS tensor NCCs on polar bases must be angularly constant.")
        profiles = moved[:, 0].reshape(ncomp_n, -1)  # (ncomp_n, Nr)
        # radial coefficients of each component profile at the NCC's level
        fwd = np.asarray(nb._radial_forward_matrix(1.0))
        U_in = recombination_matrix(tuple(operand.tensorsig), cs)
        out_tsig = (tuple(ncc.tensorsig) + tuple(operand.tensorsig)
                    if ncc_index == 0
                    else tuple(operand.tensorsig) + tuple(ncc.tensorsig))
        U_out = recombination_matrix(out_tsig, cs)
        ncomp_op = U_in.shape[0]
        real = not is_complex_dtype(self.dtype)
        sep_widths = subproblem.layout.sep_widths
        nonzero = [c for c in range(ncomp_n)
                   if np.abs(profiles[c]).max() > tol]
        total = None
        for c in (nonzero or [0]):     # all-zero NCC: one zero term (shape)
            f_coeffs = fwd @ profiles[c]
            R = sparsify(ob.radial_multiplication_matrix(f_coeffs, nb.k,
                                                         k_out=0), 1e-12)
            P_c = np.zeros((ncomp_n, 1))
            P_c[c, 0] = 1.0
            place = (np.kron(P_c, np.eye(ncomp_op)) if ncc_index == 0
                     else np.kron(np.eye(ncomp_op), P_c))
            C = U_out @ place @ U_in.conj().T
            if real:
                # joint (component, azimuth-pair) real representation: the
                # azimuth slot is the (cos, -sin) pair, so the pair action
                # is absorbed into the leading factor; that holds while no
                # wider axis precedes the annulus in the pencil ordering
                wide = [ax for ax in range(az_axis)
                        if sep_widths.get(ax, 1) != 1]
                if wide:
                    raise NonlinearOperatorError(
                        "Tensor-valued polar NCCs with real dtype require "
                        "the annulus azimuth to lead the pencil ordering "
                        f"(axes {wide} precede it with width > 1).")
                T = sp.csr_matrix(real_pair_matrix(C))
            else:
                T = sp.csr_matrix(C)
            factors = [T]
            for axis in range(self.dist.dim):
                basisx = operand.domain.bases[axis]
                if axis == az_axis:
                    if not real:
                        factors.append(sp.identity(1, format="csr"))
                elif axis == r_axis:
                    factors.append(R)
                else:
                    sub = 0 if basisx is None else axis - basisx.first_axis
                    factors.append(_axis_identity(basisx,
                                                  sep_widths.get(axis), sub))
            mat = sparse_kron(*factors)
            total = mat if total is None else total + mat
        return total

    # ---------------------------------------------- bilinear component maps

    def _coord_bilinear_map(self, ncc, operand, ncc_index):
        """
        T_coord (ncomp_out, ncomp_ncc, ncomp_operand): the product's
        bilinear map over flattened COORDINATE tensor components,
        out_c = sum_{a,b} T[c, a, b] ncc_a operand_b. Defined per product
        class (outer product, contraction, Levi-Civita)."""
        raise NotImplementedError

    def _spin_bilinear_map(self, ncc, operand, ncc_index):
        """
        T_spin: the same bilinear map conjugated into SPIN components by the
        unitary coordinate->spin recombinations U (out = U_out T_coord
        (U_ncc^H x U_op^H)). Pointwise products conserve total spin, so
        T_spin[c, a, b] != 0 only when s_out[c] = s_ncc[a] + s_op[b]
        (asserted numerically; used as the selection rule downstream).
        """
        from .curvilinear import recombination_matrix
        T = np.asarray(self._coord_bilinear_map(ncc, operand, ncc_index),
                       dtype=complex)
        U_n = recombination_matrix(tuple(ncc.tensorsig), self._sph_cs(operand))
        U_o = recombination_matrix(tuple(operand.tensorsig),
                                   self._sph_cs(operand))
        U_out = recombination_matrix(tuple(self.tensorsig),
                                     self._sph_cs(operand))
        T_spin = np.einsum("cC,Cab,Aa,Bb->cAB", U_out, T,
                           np.conj(U_n), np.conj(U_o))
        T_spin[np.abs(T_spin) < 1e-13] = 0.0
        return T_spin

    def _sph_cs(self, operand):
        basis = self._spherical_regularity_basis(operand)
        if basis is None:
            basis = self._s2_basis(operand)
        return basis.cs

    def _sph_ncc_setup(self, ncc, operand, ncc_index):
        """
        Validate a radially-directed, angularly-constant spherical NCC and
        return its assembly context (operand basis, NCC basis, radial
        profile coefficients, ranks, per-sweep cache).
        """
        from .spherical3d import spherical_rank
        basis = self._spherical_regularity_basis(operand)
        ncc_basis = self._spherical_regularity_basis(ncc)
        if basis is None or ncc_basis is None:
            raise NonlinearOperatorError(
                "Curvilinear NCCs require shell/ball bases on both factors.")
        rank_n = spherical_rank(ncc.tensorsig, basis.cs)
        rank_in = spherical_rank(operand.tensorsig, basis.cs)
        ncomp_n = 3 ** rank_n
        radial_flat = ncomp_n - 1  # flat index of (2, ..., 2)
        # Cache radial multiplication stacks across groups of ONE assembly
        # sweep, invalidated when any field feeding the NCC changes (NLBVP
        # Jacobian rebuilds re-evaluate the NCC around the moving state;
        # a stale cache froze the Newton iteration's Jacobian).
        ncc_src = self.args[ncc_index]
        if isinstance(ncc_src, Field):
            version = ((id(ncc_src), ncc_src._version),)
        else:
            version = tuple(sorted((id(a), a._version)
                                   for a in ncc_src.atoms(Field)))
        cache = getattr(self, "_sph_ncc_cache", None)
        if cache is not None and cache.get("version") != version:
            cache = None
        if cache is None:
            # Validate: only the all-radial component, angularly constant.
            grid = np.asarray(ncc["g"])
            flat = grid.reshape((ncomp_n,) + grid.shape[rank_n:])
            tol = self._ncc_data_cutoff(flat) * max(np.abs(flat).max(),
                                                    1e-300)
            for c in range(ncomp_n):
                if c != radial_flat and np.abs(flat[c]).max() > tol:
                    raise NonlinearOperatorError(
                        "LHS tensor NCCs on spherical bases must have only "
                        "radial components (e.g. f(r)*er).")
            profile = flat[radial_flat]
            if np.abs(profile - profile[:1, :1, :]).max() > tol:
                raise NonlinearOperatorError(
                    "LHS NCCs on spherical bases must be angularly constant.")
            profile_coeffs = ncc_basis.scalar_radial_coeffs(profile[0, 0],
                                                            l_env=rank_n)
            cache = self._sph_ncc_cache = {"coeffs": profile_coeffs,
                                           "version": version}
        return {"basis": basis, "ncc_basis": ncc_basis, "cache": cache,
                "sparsify_cutoff":
                    self._ncc_sparsify_cutoff(np.dtype(ncc.dtype)),
                "rank_n": rank_n, "rank_in": rank_in,
                "rank_out": spherical_rank(self.tensorsig, basis.cs),
                "T_spin": self._spin_bilinear_map(ncc, operand, ncc_index),
                "radial_flat": radial_flat, "ncc_index": ncc_index}

    def _sph_ncc_pairs(self, setup, ell):
        """
        [(i, j, C_ij, M_ij)] for one ell: the Q-intertwined component
        coupling C = Q_out^T P Q_in (P = the product's spin bilinear map
        contracted against the radial NCC slot, so Multiply/Dot/Cross all
        route through here) and per-(ell, regularity) radial multiplication
        matrices.
        """
        from .spherical3d import q_stack, reg_totals
        basis = setup["basis"]
        cache = setup["cache"]
        rank_n, rank_in = setup["rank_n"], setup["rank_in"]
        rank_out = setup["rank_out"]
        ncomp_in = 3 ** rank_in
        P = setup["T_spin"][:, setup["radial_flat"], :]
        if np.abs(P.imag).max() < 1e-13:
            P = P.real
        totals_in = reg_totals(rank_in)
        totals_out = reg_totals(rank_out)
        Q_in = q_stack(basis.Ntheta, rank_in)[ell]
        Q_out = q_stack(basis.Ntheta, rank_out)[ell]
        C = Q_out.T @ P @ Q_in
        out = []
        for i in range(3 ** rank_out):
            for j in range(ncomp_in):
                if abs(C[i, j]) < 1e-12:
                    continue
                key = (int(totals_in[j]), int(totals_out[i]), int(ell))
                M = cache.get(key)
                if M is None:
                    M = sparsify(basis.ncc_radial_matrix(
                        cache["coeffs"], setup["ncc_basis"].k, totals_in[j],
                        totals_out[i], ell, k_out=0, l_env=rank_n),
                        setup["sparsify_cutoff"])
                    cache[key] = M
                out.append((i, j, C[i, j], M))
        return out

    def _spherical_ncc_matrix(self, subproblem, ncc, operand, ncc_index):
        """
        Pencil matrix for multiplication by a radially-directed,
        angularly-constant NCC (f(r), f(r)*er, f(r)*er*er, ...) over the
        shell basis: per-(m, ell) group, the Q-intertwined component
        coupling kron'd with per-(ell, regularity) radial multiplication
        matrices (dedalus_tpu/core/arithmetic.py:1027; reference:
        core/arithmetic.py:559 Gamma machinery, restricted to the
        radial-NCC case the shell examples use). On an ell-coupled layout
        it assembles through _sph_coupled_ncc_matrix.
        """
        layout = subproblem.layout
        pre_basis = self._spherical_regularity_basis(operand)
        colat_axis = pre_basis.first_axis + 1
        if subproblem.group[colat_axis] is None:
            # layout-coupled colatitude (theta-dependent NCC somewhere in
            # the problem): ell-coupled assembly
            return self._sph_coupled_ncc_matrix(subproblem, ncc, operand,
                                                ncc_index)
        setup = self._sph_ncc_setup(ncc, operand, ncc_index)
        basis = setup["basis"]
        az_axis = basis.first_axis
        ell = subproblem.group[colat_axis]
        ncomp_in = 3 ** setup["rank_in"]
        rank_out = setup["rank_out"]
        gs = layout.sep_widths[az_axis]
        I_gs = sp.identity(gs, format="csr")
        Nr = basis.Nr
        total = sp.csr_matrix((3 ** rank_out * gs * Nr, ncomp_in * gs * Nr))
        for i, j, Cij, M in self._sph_ncc_pairs(setup, ell):
            sel = sp.csr_matrix(
                (np.ones(1), ([i], [j])), shape=(3 ** rank_out, ncomp_in))
            total = total + Cij * sparse_kron(sel, I_gs, M)
        return total

    NCC_ANGULAR_CUTOFF = 1e-10

    @staticmethod
    def _ncc_real_eps(arr_or_dtype):
        """Machine epsilon of the SOURCE data precision. Accepts an array
        or a dtype; complex dtypes resolve to their real component. The
        source dtype matters because expansions get promoted to f64/c128
        on the host — the promotion launders the f32-level roundoff that
        the cutoffs must track."""
        if isinstance(arr_or_dtype, (np.dtype, type)):
            dt = np.dtype(arr_or_dtype)
        else:
            dt = np.asarray(arr_or_dtype).dtype
        dt = np.dtype(dt)
        if dt.kind == "c":
            dt = np.dtype(np.float32) if dt.itemsize == 8 \
                else np.dtype(np.float64)
        return np.finfo(dt).eps if dt.kind == "f" else 0.0

    @staticmethod
    def _ncc_sparsify_cutoff(arr_or_dtype):
        """Relative sparsify threshold for matrices BUILT from NCC data:
        f32-sourced coefficient vectors carry ~eps-relative junk in every
        entry, which would otherwise populate spurious matrix diagonals
        and defeat band detection."""
        return max(1e-12, 10 * ProductBase._ncc_real_eps(arr_or_dtype))

    @staticmethod
    def _ncc_data_cutoff(arr_or_dtype):
        """Relative significance cutoff for NCC data, scaled to the data's
        own precision (f32 data carries ~1e-7-relative roundoff in every
        coefficient)."""
        return max(ProductBase.NCC_ANGULAR_CUTOFF,
                   50 * ProductBase._ncc_real_eps(arr_or_dtype))

    @staticmethod
    def polar_azimuth_varies(ncc, basis):
        """Does a disk/annulus NCC vary with azimuth? Grid-space and
        dtype-aware, the classifier of the JAX package
        (dedalus_tpu/core/arithmetic.py:1099), shared by the layout
        (subsystems._ncc_forced_coupled_axes) and the term assembly."""
        grid = np.asarray(ncc["g"])
        az = len(ncc.tensorsig) + basis.first_axis
        moved = np.moveaxis(grid, az, 0)
        tol = (ProductBase._ncc_data_cutoff(grid)
               * max(np.abs(grid).max(), 1e-300))
        return bool(np.abs(moved - moved[:1]).max() > tol)

    @staticmethod
    def sph_ncc_angular_profile(ncc, basis, cs):
        """
        Classify a spherical NCC's angular structure from its grid data.
        Returns (spin_profiles, tol): spin_profiles[a] = (Ntheta, Nr) theta-
        radial data of flattened SPIN component a (axisymmetry along phi is
        validated here), tol the absolute significance cutoff. Used both by
        the layout coupling detection (subsystems._ncc_forced_coupled_axes)
        and the coupled assembly.
        """
        from .curvilinear import recombination_matrix
        rank_n = len(ncc.tensorsig)
        ncomp = int(np.prod(ncc.tshape, dtype=int)) if ncc.tshape else 1
        ncc.change_scales(1)
        grid = np.asarray(ncc["g"])
        flat = grid.reshape((ncomp,) + grid.shape[rank_n:])
        if flat.ndim == 3:  # standalone S2: insert a trivial radial axis
            flat = flat[..., None]
        tol = ProductBase._ncc_data_cutoff(flat) * max(np.abs(flat).max(),
                                                       1e-300)
        if np.abs(flat - flat[:, :1]).max() > tol:
            raise NonlinearOperatorError(
                "LHS NCCs on spherical bases must be axisymmetric (constant "
                "along phi); only theta/radial variation is supported.")
        prof = flat[:, 0]                       # (ncomp, Ntheta, Nr)
        U = recombination_matrix(tuple(ncc.tensorsig), cs)
        spin_prof = np.einsum("ac,ctr->atr", U, prof.astype(complex))
        return spin_prof, tol

    def _sph_ncc_general_data(self, ncc, operand, basis, ncc_basis,
                              ncc_index):
        """
        Expansion of a theta/radius-dependent axisymmetric NCC for the
        ell-coupled assembly: per flattened spin component a, the list of
        (L, B_L) with B_L the radial multiplication matrix (operand level-k
        -> level-0) of the NCC's Y_{L,(0,s_a)} angular mode's radial
        profile (reference: the theta-dependent Clenshaw NCC pipeline,
        dedalus/core/arithmetic.py:359-406 + basis.py:611-628, rebuilt
        by SWSH + Gauss quadrature).
        """
        from ..libraries import sphere as swsh
        ncc_src = self.args[ncc_index]
        if isinstance(ncc_src, Field):
            version = ((id(ncc_src), ncc_src._version),)
        else:
            version = tuple(sorted((id(a), a._version)
                                   for a in ncc_src.atoms(Field)))
        version = version + (("k", getattr(basis, "k", 0)),)
        cache = getattr(self, "_sph_gen_cache", None)
        if cache is not None and cache.get("version") == version:
            return cache
        from .spherical3d import ShellBasis, spherical_rank
        spin_prof, tol = self.sph_ncc_angular_profile(ncc, basis, basis.cs)
        spins = component_spins(ncc.tensorsig, basis.cs)
        rank_n = spherical_rank(ncc.tensorsig, basis.cs)
        shell = isinstance(basis, ShellBasis)
        Lmax_n = ncc_basis.Lmax
        Ntheta_n = spin_prof.shape[1]
        terms = {}
        max_L = 0
        for a in range(spin_prof.shape[0]):
            pa = spin_prof[a]
            if np.abs(pa).max() <= tol:
                continue
            s_a = int(spins[a])
            F = swsh.forward_matrix(Lmax_n, 0, s_a, Ng=Ntheta_n) @ pa
            l0 = swsh.lmin(0, s_a)
            rows = []
            for i in range(F.shape[0]):
                if np.abs(F[i]).max() <= tol:
                    continue
                L = l0 + i
                coeffs = F[i]
                if np.abs(coeffs.imag).max() < 1e-13 * max(
                        np.abs(coeffs).max(), 1e-300):
                    coeffs = coeffs.real
                if shell:
                    # the shell's radial space is ell-independent: one
                    # multiplication matrix per (a, L)
                    B = sparsify(basis.radial_multiplication_matrix(
                        ncc_basis.scalar_radial_coeffs(coeffs),
                        ncc_basis.k, k_out=0),
                        self._ncc_sparsify_cutoff(np.dtype(ncc.dtype)))
                    rows.append((L, B))
                else:
                    # the ball's Zernike spaces are ell-indexed: store the
                    # profile's Zernike coefficients (the minimal smooth
                    # envelope degree has parity L + rank and vanishing
                    # order >= L - rank) and build per-(ell, ell') pair
                    # matrices lazily at assembly
                    l_env = max(L - rank_n, (L + rank_n) % 2)
                    if np.iscomplexobj(coeffs):
                        rc = (ncc_basis.scalar_radial_coeffs(
                                  coeffs.real, l_env=l_env)
                              + 1j * ncc_basis.scalar_radial_coeffs(
                                  coeffs.imag, l_env=l_env))
                    else:
                        rc = ncc_basis.scalar_radial_coeffs(coeffs,
                                                            l_env=l_env)
                    rows.append((L, (rc, l_env)))
                max_L = max(max_L, L)
            if rows:
                terms[a] = rows
        cache = self._sph_gen_cache = {"version": version, "terms": terms,
                                       "spins": spins, "max_L": max_L,
                                       "pair_cache": {}}
        return cache

    def _sph_coupled_ncc_matrix(self, subproblem, ncc, operand, ncc_index):
        """
        Pencil matrix of this product at one azimuthal group of an
        ell-COUPLED layout: the NCC may vary along theta and radius
        (e.g. the ez Coriolis vector of rotating convection). Assembly:
        SWSH triple-product coupling matrices W_L[l', l] (quadrature-exact
        Gaunt couplings) kron radial multiplication matrices B_L, summed
        over the NCC's (spin component, L) modes and sandwiched between
        the per-ell regularity<->spin intertwiners Q
        (reference: dedalus/core/arithmetic.py:359-406 prep_nccs /
        build_ncc_matrices with Clenshaw, core/basis.py:611-628).
        """
        from .spherical3d import q_stack, spherical_rank, ShellBasis
        from ..libraries import sphere as swsh
        basis = self._spherical_regularity_basis(operand)
        ncc_basis = self._spherical_regularity_basis(ncc)
        if basis is None or ncc_basis is None:
            raise NonlinearOperatorError(
                "Curvilinear NCCs require shell/ball bases on both factors.")
        if not isinstance(basis, ShellBasis):
            return self._sph_coupled_ncc_matrix_ball(subproblem, ncc,
                                                     operand, ncc_index)
        layout = subproblem.layout
        az = basis.first_axis
        gs = layout.sep_widths[az]
        ms = basis.group_m()
        g = subproblem.group[az]
        m = int(ms[g])
        Lmax = basis.Lmax
        Ntheta, Nr = basis.Ntheta, basis.Nr
        rank_in = spherical_rank(operand.tensorsig, basis.cs)
        rank_out = spherical_rank(self.tensorsig, basis.cs)
        nin, nout = 3 ** rank_in, 3 ** rank_out
        shape = (nout * gs * Ntheta * Nr, nin * gs * Ntheta * Nr)
        if basis.complex and g == basis.Nphi // 2:
            return sp.csr_matrix(shape)  # Nyquist: all slots invalid
        T_spin = self._spin_bilinear_map(ncc, operand, ncc_index)
        data = self._sph_ncc_general_data(ncc, operand, basis, ncc_basis,
                                          ncc_index)
        s_in = component_spins(operand.tensorsig, basis.cs)
        s_out = component_spins(self.tensorsig, basis.cs)
        s_ncc = data["spins"]
        Qi = q_stack(Ntheta, rank_in)     # (Ntheta, nin, nin) spin x reg
        Qo = q_stack(Ntheta, rank_out)
        I_r = sp.identity(Nr, format="csr")

        def embed_W(W, sc, sb):
            """Place the (l'-slot, l-slot) W into full (Ntheta, Ntheta)."""
            out = np.zeros((Ntheta, Ntheta))
            r0 = swsh.lmin(m, sc)
            c0 = swsh.lmin(m, sb)
            out[r0:r0 + W.shape[0], c0:c0 + W.shape[1]] = W
            return out

        total = sp.csr_matrix((nout * Ntheta * Nr, nin * Ntheta * Nr),
                              dtype=complex)
        # Q sandwiches are m-independent: cache across the group sweep
        # (the per-m cost is then only the W couplings, which are
        # themselves cached by (m, spins, L))
        qcache = data.setdefault("q_sandwich", {})
        key_R = ("R", rank_out, Ntheta, Nr)
        key_C = ("C", rank_in, Ntheta, Nr)
        if key_R not in qcache:
            qcache[key_R] = [sp.vstack([
                sparse_kron(sp.diags(Qo[:, c, gam]), I_r)
                for gam in range(nout)], format="csr")
                for c in range(nout)]
        if key_C not in qcache:
            qcache[key_C] = [sp.hstack([
                sparse_kron(sp.diags(Qi[:, b, bet]), I_r)
                for bet in range(nin)], format="csr")
                for b in range(nin)]
        R_all = qcache[key_R]
        C_all = qcache[key_C]
        for c in range(nout):
            sc = int(s_out[c])
            R_c = R_all[c]
            for b in range(nin):
                sb = int(s_in[b])
                A_cb = None
                for a, rows in data["terms"].items():
                    t = T_spin[c, a, b]
                    if abs(t) < 1e-13:
                        continue
                    if sc != int(s_ncc[a]) + sb:
                        raise ValueError(
                            "Spin balance violated in NCC assembly "
                            f"(s_out={sc}, s_ncc={int(s_ncc[a])}, s_in={sb}).")
                    for L, B in rows:
                        W = swsh.triple_product_matrix(
                            Lmax, m, sc, int(s_ncc[a]), sb, L)
                        if W.size == 0 or np.abs(W).max() == 0.0:
                            continue
                        Wl = sparsify(embed_W(W, sc, sb), 1e-14)
                        term = t * sparse_kron(Wl, B)
                        A_cb = term if A_cb is None else A_cb + term
                if A_cb is None:
                    continue
                C_b = C_all[b]
                total = total + R_c @ A_cb @ C_b
        # Canonicalize BEFORE any derived views: .imag/.real of a
        # non-canonical CSR share index arrays with the parent, and
        # canonicalizing the view in place corrupts the parent
        # (scipy _with_data aliasing).
        total = total.tocoo().tocsr()
        # imaginary parts at the SOURCE dtype's roundoff are residue, not
        # couplings (f32 data leaves ~1e-7-relative imag junk whose pair-J
        # representation would litter the band structure)
        imag_tol = max(1e-13, 100 * self._ncc_real_eps(np.dtype(ncc.dtype)))
        total = _filter_rel(total, self._ncc_sparsify_cutoff(np.dtype(ncc.dtype)))
        if total.nnz and np.abs(total.imag).max() < imag_tol * max(
                np.abs(total).max(), 1e-300):
            total = total.real
        elif not is_complex_dtype(self.dtype) and gs < 2:
            raise NonlinearOperatorError(
                "This NCC product assembles complex couplings (e.g. a cross "
                "product) with no azimuthal pair slots to carry them; use a "
                "complex dtype, or move the term to the RHS.")
        if gs > 1:
            # slot layout is (component, azimuthal pair, ell, n): interleave
            # between the component and ell kron positions (complex
            # couplings act through the real 2x2 pair representation)
            total = _interleave_gs(total, nout, nin, gs, Ntheta * Nr)
        return sp.csr_matrix(total)

    def _sph_coupled_ncc_matrix_ball(self, subproblem, ncc, operand,
                                     ncc_index):
        """
        Ball variant of the ell-coupled NCC assembly: Zernike radial
        spaces are ell-indexed, so the kron(W, B) factorization of the
        shell does not apply — each (ell', ell) block combines the SWSH
        triple-product coupling with a PER-PAIR radial multiplication
        matrix mapping Z^(ell + t_in) -> Z^(ell' + t_out)
        (dedalus_tpu/core/arithmetic.py:1348; reference: the l-coupled Zernike Clenshaw couplings,
        dedalus/core/basis.py:4101 + core/arithmetic.py:359-406).
        """
        from .spherical3d import q_stack, spherical_rank, reg_totals
        from ..libraries import sphere as swsh
        basis = self._spherical_regularity_basis(operand)
        ncc_basis = self._spherical_regularity_basis(ncc)
        layout = subproblem.layout
        az = basis.first_axis
        gs = layout.sep_widths[az]
        ms = basis.group_m()
        g = subproblem.group[az]
        m = int(ms[g])
        Lmax = basis.Lmax
        Ntheta, Nr = basis.Ntheta, basis.Nr
        rank_in = spherical_rank(operand.tensorsig, basis.cs)
        rank_out = spherical_rank(self.tensorsig, basis.cs)
        nin, nout = 3 ** rank_in, 3 ** rank_out
        shape = (nout * gs * Ntheta * Nr, nin * gs * Ntheta * Nr)
        if basis.complex and g == basis.Nphi // 2:
            return sp.csr_matrix(shape)  # Nyquist: all slots invalid
        T_spin = self._spin_bilinear_map(ncc, operand, ncc_index)
        data = self._sph_ncc_general_data(ncc, operand, basis, ncc_basis,
                                          ncc_index)
        s_in = component_spins(operand.tensorsig, basis.cs)
        s_out = component_spins(self.tensorsig, basis.cs)
        s_ncc = data["spins"]
        t_in = reg_totals(rank_in)
        t_out = reg_totals(rank_out)
        Qi = q_stack(Ntheta, rank_in)
        Qo = q_stack(Ntheta, rank_out)
        pair_cache = data["pair_cache"]
        flat_terms = [(a, L, payload)
                      for a, rows in data["terms"].items()
                      for L, payload in rows]
        max_L = data["max_L"]
        X0 = Ntheta * Nr
        rows_l, cols_l, vals_l = [], [], []
        for lp in range(Ntheta):            # ell' (output)
            for l in range(max(0, lp - max_L),
                           min(Ntheta, lp + max_L + 1)):   # ell (input)
                # angular x tensor coefficient per (gamma, beta, term)
                A3 = np.zeros((nout, nin, len(flat_terms)), dtype=complex)
                for ti, (a, L, payload) in enumerate(flat_terms):
                    sa = int(s_ncc[a])
                    for c in range(nout):
                        sc = int(s_out[c])
                        for b in range(nin):
                            t = T_spin[c, a, b]
                            if abs(t) < 1e-13:
                                continue
                            sb = int(s_in[b])
                            W = swsh.triple_product_matrix(Lmax, m, sc,
                                                           sa, sb, L)
                            r0 = swsh.lmin(m, sc)
                            c0 = swsh.lmin(m, sb)
                            if (lp < r0 or l < c0
                                    or lp - r0 >= W.shape[0]
                                    or l - c0 >= W.shape[1]):
                                continue
                            w = W[lp - r0, l - c0]
                            if w == 0.0:
                                continue
                            A3[:, :, ti] += (t * w) * np.outer(
                                Qo[lp][c], Qi[l][b])
                if not np.abs(A3).any():
                    continue
                for gam in range(nout):
                    for bet in range(nin):
                        coefs = A3[gam, bet]
                        if not np.abs(coefs).any():
                            continue
                        blk = None
                        for ti, (a, L, payload) in enumerate(flat_terms):
                            cf = coefs[ti]
                            if abs(cf) < 1e-14:
                                continue
                            rc, l_env = payload
                            key = (id(rc), int(t_in[bet]), int(t_out[gam]),
                                   l, lp)
                            B = pair_cache.get(key)
                            if B is None:
                                B = sparsify(basis.ncc_radial_pair_matrix(
                                    rc, ncc_basis.k, l_env, t_in[bet],
                                    t_out[gam], l, lp, k_out=0),
                                    self._ncc_sparsify_cutoff(np.dtype(ncc.dtype)))
                                pair_cache[key] = B
                            term = cf * B
                            blk = term if blk is None else blk + term
                        if blk is None or blk.nnz == 0:
                            continue
                        coo = blk.tocoo()
                        rows_l.append(gam * X0 + lp * Nr + coo.row)
                        cols_l.append(bet * X0 + l * Nr + coo.col)
                        vals_l.append(coo.data)
        if rows_l:
            total = sp.csr_matrix(
                (np.concatenate(vals_l),
                 (np.concatenate(rows_l), np.concatenate(cols_l))),
                shape=(nout * X0, nin * X0))
        else:
            total = sp.csr_matrix((nout * X0, nin * X0), dtype=complex)
        total = total.tocoo().tocsr()
        imag_tol = max(1e-13, 100 * self._ncc_real_eps(np.dtype(ncc.dtype)))
        total = _filter_rel(total, self._ncc_sparsify_cutoff(np.dtype(ncc.dtype)))
        if total.nnz and np.abs(total.imag).max() < imag_tol * max(
                np.abs(total).max(), 1e-300):
            total = total.real
        elif total.nnz and not is_complex_dtype(self.dtype) and gs < 2:
            raise NonlinearOperatorError(
                "This NCC product assembles complex couplings with no "
                "azimuthal pair slots to carry them; use a complex dtype, "
                "or move the term to the RHS.")
        if gs > 1:
            total = _interleave_gs(total, nout, nin, gs, X0)
        return sp.csr_matrix(total)

    def _s2_coupled_ncc_matrix(self, subproblem, ncc, operand, ncc_index):
        """
        Pencil matrix of a product with an axisymmetric NCC on the
        standalone 2D SPHERE (e.g. a zonal background U(theta) in a
        linearized shallow-water problem): the surface analogue of the
        shell's coupled path — SWSH triple-product couplings with scalar
        (L-mode) coefficients, no radial factor. Sphere coefficients are
        already spin components, so no Q intertwiner sandwich is needed
        (reference: dedalus/core/arithmetic.py:359-406 restricted to S2).
        """
        from ..libraries import sphere as swsh
        basis = self._s2_basis(operand)
        ncc_basis = self._s2_basis(ncc)
        if basis is None or ncc_basis is None:
            raise NonlinearOperatorError(
                "S2 NCC products require sphere bases on both factors.")
        layout = subproblem.layout
        az = basis.first_axis
        colat = az + 1
        if subproblem.group[colat] is not None:
            raise NonlinearOperatorError(
                "S2 NCC products require the colatitude coupled "
                "(standalone sphere problems).")
        gs = layout.sep_widths[az]
        ms = basis.group_m()
        g = subproblem.group[az]
        m = int(ms[g])
        Lmax = basis.Lmax
        Ntheta = basis.Ntheta
        nin = int(np.prod(operand.tshape, dtype=int)) if operand.tshape else 1
        nout = int(np.prod(self.tshape, dtype=int)) if self.tshape else 1
        shape = (nout * gs * Ntheta, nin * gs * Ntheta)
        if basis.complex and g == basis.Nphi // 2:
            return sp.csr_matrix(shape)  # Nyquist
        T_spin = self._spin_bilinear_map(ncc, operand, ncc_index)
        spin_prof, tol = self.sph_ncc_angular_profile(ncc, basis, basis.cs)
        s_ncc = component_spins(ncc.tensorsig, basis.cs)
        s_in = component_spins(operand.tensorsig, basis.cs)
        s_out = component_spins(self.tensorsig, basis.cs)
        total = sp.csr_matrix((nout * Ntheta, nin * Ntheta), dtype=complex)
        for a in range(spin_prof.shape[0]):
            pa = spin_prof[a][:, 0]
            if np.abs(pa).max() <= tol:
                continue
            sa = int(s_ncc[a])
            F = swsh.forward_matrix(ncc_basis.Lmax, 0, sa) @ pa
            l0 = swsh.lmin(0, sa)
            for c in range(nout):
                sc = int(s_out[c])
                for b in range(nin):
                    t = T_spin[c, a, b]
                    if abs(t) < 1e-13:
                        continue
                    sb = int(s_in[b])
                    if sc != sa + sb:
                        raise ValueError(
                            "Spin balance violated in S2 NCC assembly.")
                    blk = None
                    for i in range(F.shape[0]):
                        if abs(F[i]) <= tol:
                            continue
                        L = l0 + i
                        W = swsh.triple_product_matrix(Lmax, m, sc, sa,
                                                       sb, L)
                        if W.size == 0 or np.abs(W).max() == 0.0:
                            continue
                        emb = np.zeros((Ntheta, Ntheta))
                        r0 = swsh.lmin(m, sc)
                        c0 = swsh.lmin(m, sb)
                        emb[r0:r0 + W.shape[0], c0:c0 + W.shape[1]] = W
                        term = (t * F[i]) * sparsify(emb, 1e-14)
                        blk = term if blk is None else blk + term
                    if blk is None:
                        continue
                    place = sp.csr_matrix(
                        (np.ones(1), ([c], [b])), shape=(nout, nin))
                    total = total + sp.kron(place, blk, format="csr")
        total = total.tocoo().tocsr()
        imag_tol = max(1e-13, 100 * self._ncc_real_eps(np.dtype(ncc.dtype)))
        total = _filter_rel(total, self._ncc_sparsify_cutoff(np.dtype(ncc.dtype)))
        if total.nnz and np.abs(total.imag).max() < imag_tol * max(
                np.abs(total).max(), 1e-300):
            total = total.real
        elif total.nnz and not is_complex_dtype(self.dtype) and gs < 2:
            raise NonlinearOperatorError(
                "This S2 NCC product assembles complex couplings with no "
                "azimuthal pair slots to carry them; use a complex dtype, "
                "or move the term to the RHS.")
        if gs > 1:
            total = _interleave_gs(total, nout, nin, gs, Ntheta)
        return sp.csr_matrix(total)

    def _assemble_ncc_matrix(self, subproblem, ncc, operand, tensor_factor_fn):
        """
        Sum over NCC components: kron(tensor_factor(comp), axis factors).
        `tensor_factor_fn(comp_index, value_is_scalar)` returns the sparse
        tensor factor for that component.
        """
        from .operators import _axis_identity
        operand_domain = operand.domain
        sep_widths = subproblem.layout.sep_widths
        total = None
        comp_indices = list(np.ndindex(*ncc.tshape)) if ncc.tshape else [()]
        for comp in comp_indices:
            for scalar, descrs in self._ncc_axis_terms(ncc, comp, operand):
                factors = [tensor_factor_fn(comp)]
                if scalar is not None and not np.isscalar(scalar):
                    # a component-mixing tensor factor (the real-pair
                    # expansion of an azimuthally varying polar NCC)
                    # composes with the component placement on the left
                    factors[0] = sp.csr_matrix(np.asarray(scalar)) \
                        @ sp.csr_matrix(factors[0])
                    scalar = None
                for axis, descr in enumerate(descrs):
                    ob = operand_domain.bases[axis]
                    if descr is None:
                        sub = 0 if ob is None else axis - ob.first_axis
                        factors.append(_axis_identity(ob,
                                                      sep_widths.get(axis),
                                                      sub))
                    else:
                        factors.append(descr[1])
                mat = sparse_kron(*factors)
                if scalar is not None:
                    mat = scalar * mat
                total = mat if total is None else total + mat
        return total


class MultiplyFields(ProductBase):
    """Pointwise (tensor outer) product (reference: core/arithmetic.py:822)."""

    name = "Mul"

    def _build_metadata(self):
        a, b = self.args
        self.tensorsig = tuple(a.tensorsig) + tuple(b.tensorsig)
        self.domain = _product_domain(self.dist, [a, b])
        self.dtype = _promote_dtype(self.args)

    def __repr__(self):
        return f"({self.args[0]}*{self.args[1]})"

    def ev_impl(self, ctx):
        a, b = self.args
        da = ev(a, ctx, "g")
        db = ev(b, ctx, "g")
        ta, tb = a.tdim, b.tdim
        da_x = da.reshape(da.shape[:ta] + (1,) * tb + da.shape[ta:])
        return da_x * db  # broadcasting over tensor + constant grid axes

    def _coord_bilinear_map(self, ncc, operand, ncc_index):
        nn = int(np.prod(ncc.tshape, dtype=int)) if ncc.tshape else 1
        no = int(np.prod(operand.tshape, dtype=int)) if operand.tshape else 1
        T = np.zeros((nn * no, nn, no))
        a, b = np.meshgrid(np.arange(nn), np.arange(no), indexing="ij")
        if ncc_index == 0:
            T[(a * no + b).ravel(), a.ravel(), b.ravel()] = 1.0
        else:
            T[(b * nn + a).ravel(), a.ravel(), b.ravel()] = 1.0
        return T

    def expression_matrices(self, subproblem, vars, **kw):
        ncc_index, ncc, operand = self._split_ncc(vars, subproblem.layout)
        if self._spherical_regularity_basis(ncc) is not None:
            M = self._spherical_ncc_matrix(subproblem, ncc, operand,
                                           ncc_index)
            op_mats = operand_expression_matrices(operand, subproblem, vars,
                                                  **kw)
            return {var: M @ mat for var, mat in op_mats.items()}
        if (self._s2_basis(ncc) is not None
                and self._spherical_regularity_basis(operand) is None):
            M = self._s2_coupled_ncc_matrix(subproblem, ncc, operand,
                                            ncc_index)
            op_mats = operand_expression_matrices(operand, subproblem, vars,
                                                  **kw)
            return {var: M @ mat for var, mat in op_mats.items()}
        pol = self._polar_spin_basis(ncc)
        if pol is not None and (ncc.tensorsig or not hasattr(
                pol, "radial_multiplication_matrix")):
            if hasattr(pol, "radial_multiplication_matrix"):
                # annulus: spin-independent radial space, one matrix
                M = self._polar_tensor_ncc_matrix(subproblem, ncc, operand,
                                                  ncc_index)
            else:
                # disk: per-(m, spin) Zernike stacks
                n_n = int(np.prod(ncc.tshape, dtype=int)) if ncc.tshape else 1
                n_op = int(np.prod(operand.tshape, dtype=int)) \
                    if operand.tshape else 1

                def place(c):
                    P = np.zeros((n_n, 1))
                    P[c, 0] = 1.0
                    return (np.kron(P, np.eye(n_op)) if ncc_index == 0
                            else np.kron(np.eye(n_op), P))

                M = self._disk_ncc_matrix(subproblem, ncc, operand, place)
            op_mats = operand_expression_matrices(operand, subproblem, vars,
                                                  **kw)
            return {var: M @ mat for var, mat in op_mats.items()}
        ncomp_op = int(np.prod([cs.dim for cs in operand.tensorsig], dtype=int)) \
            if operand.tensorsig else 1
        ncomp_ncc_shape = ncc.tshape

        def tensor_factor(comp):
            # column selecting the ncc component within the output tensorsig
            n_ncc = int(np.prod(ncomp_ncc_shape, dtype=int)) if ncomp_ncc_shape else 1
            col = sp.lil_matrix((n_ncc, 1))
            flat = int(np.ravel_multi_index(comp, ncomp_ncc_shape)) if comp else 0
            col[flat, 0] = 1.0
            col = sp.csr_matrix(col)
            I_op = sp.identity(ncomp_op, format="csr")
            if ncc_index == 0:
                return sparse_kron(col, I_op)
            return sparse_kron(I_op, col)

        M = self._assemble_ncc_matrix(subproblem, ncc, operand, tensor_factor)
        op_mats = operand_expression_matrices(operand, subproblem, vars, **kw)
        return {var: M @ mat for var, mat in op_mats.items()}


class DotProduct(ProductBase):
    """
    Contraction of the last index of the first operand with the first index
    of the second (reference: core/arithmetic.py:586).
    """

    name = "Dot"

    def __init__(self, a, b):
        if _is_scalar(a) or _is_scalar(b):
            raise ValueError("DotProduct requires tensor operands.")
        if not a.tensorsig or not b.tensorsig:
            raise ValueError("DotProduct requires tensor operands.")
        if a.tensorsig[-1].dim != b.tensorsig[0].dim:
            raise ValueError("Contracted dimensions do not match.")
        super().__init__(a, b)

    def _build_metadata(self):
        a, b = self.args
        self.tensorsig = tuple(a.tensorsig[:-1]) + tuple(b.tensorsig[1:])
        self.domain = _product_domain(self.dist, [a, b])
        self.dtype = _promote_dtype(self.args)

    def __repr__(self):
        return f"({self.args[0]}@{self.args[1]})"

    def _coord_bilinear_map(self, ncc, operand, ncc_index):
        if ncc_index == 0:
            lead = ncc.tshape[:-1]
            rest = operand.tshape[1:]
            d = ncc.tshape[-1]
            nl = int(np.prod(lead, dtype=int)) if lead else 1
            nr_ = int(np.prod(rest, dtype=int)) if rest else 1
            T = np.zeros((nl * nr_, nl * d, d * nr_))
            for al in range(nl):
                for ro in range(nr_):
                    for j in range(d):
                        T[al * nr_ + ro, al * d + j, j * nr_ + ro] = 1.0
        else:
            lead = operand.tshape[:-1]
            rest = ncc.tshape[1:]
            d = ncc.tshape[0]
            nl = int(np.prod(lead, dtype=int)) if lead else 1
            nr_ = int(np.prod(rest, dtype=int)) if rest else 1
            T = np.zeros((nl * nr_, d * nr_, nl * d))
            for al in range(nl):
                for ro in range(nr_):
                    for j in range(d):
                        T[al * nr_ + ro, j * nr_ + ro, al * d + j] = 1.0
        return T

    @staticmethod
    def contraction_subscripts(ta, tb):
        """einsum subscripts contracting the left factor's LAST tensor
        index with the right factor's FIRST."""
        letters = "abcdefghijklm"
        l_sub = letters[:ta - 1] + "z" + "..."
        r_sub = "z" + letters[ta - 1:ta - 1 + tb - 1] + "..."
        o_sub = letters[:ta - 1] + letters[ta - 1:ta - 1 + tb - 1] + "..."
        return l_sub, r_sub, o_sub

    def ev_impl(self, ctx):
        a, b = self.args
        da = ev(a, ctx, "g")
        db = ev(b, ctx, "g")
        l_sub, r_sub, o_sub = self.contraction_subscripts(a.tdim, b.tdim)
        return torch.einsum(f"{l_sub},{r_sub}->{o_sub}", da, db)

    def expression_matrices(self, subproblem, vars, **kw):
        ncc_index, ncc, operand = self._split_ncc(vars, subproblem.layout)
        d = ncc.tensorsig[-1].dim if ncc_index == 0 else ncc.tensorsig[0].dim

        if ncc_index == 0:
            # out comps: ncc[:-1] + op[1:]; contraction over op's first index
            rest_op = operand.tshape[1:]
            n_rest_op = int(np.prod(rest_op, dtype=int)) if rest_op else 1
            lead_ncc = ncc.tshape[:-1]
            n_lead = int(np.prod(lead_ncc, dtype=int)) if lead_ncc else 1

            def tensor_factor(comp):
                *alpha, j = comp
                lead_flat = int(np.ravel_multi_index(tuple(alpha), lead_ncc)) if lead_ncc else 0
                col = sp.lil_matrix((n_lead, 1)); col[lead_flat, 0] = 1.0
                row = sp.lil_matrix((1, d)); row[0, j] = 1.0
                return sparse_kron(sp.csr_matrix(col), sp.csr_matrix(row),
                                   sp.identity(n_rest_op, format="csr"))
        else:
            # operand @ ncc: contract operand's last index with ncc's first
            lead_op = operand.tshape[:-1]
            n_lead_op = int(np.prod(lead_op, dtype=int)) if lead_op else 1
            rest_ncc = ncc.tshape[1:]
            n_rest = int(np.prod(rest_ncc, dtype=int)) if rest_ncc else 1

            def tensor_factor(comp):
                j, *beta = comp
                rest_flat = int(np.ravel_multi_index(tuple(beta), rest_ncc)) if rest_ncc else 0
                row = sp.lil_matrix((1, d)); row[0, j] = 1.0
                col = sp.lil_matrix((n_rest, 1)); col[rest_flat, 0] = 1.0
                return sparse_kron(sp.identity(n_lead_op, format="csr"),
                                   sp.csr_matrix(row), sp.csr_matrix(col))

        if self._spherical_regularity_basis(ncc) is not None:
            M = self._spherical_ncc_matrix(subproblem, ncc, operand,
                                           ncc_index)
            op_mats = operand_expression_matrices(operand, subproblem, vars,
                                                  **kw)
            return {var: M @ mat for var, mat in op_mats.items()}
        if (self._s2_basis(ncc) is not None
                and self._spherical_regularity_basis(operand) is None):
            M = self._s2_coupled_ncc_matrix(subproblem, ncc, operand,
                                            ncc_index)
            op_mats = operand_expression_matrices(operand, subproblem, vars,
                                                  **kw)
            return {var: M @ mat for var, mat in op_mats.items()}
        pol = self._polar_spin_basis(ncc)
        if pol is not None and not hasattr(pol, "radial_multiplication_matrix"):
            # disk contraction (e.g. pipe flow's u@grad(w0)): the same
            # coordinate placement feeds the per-(m, spin) stack path
            def place(cflat):
                comp = tuple(np.unravel_index(cflat, ncc.tshape))
                return np.asarray(tensor_factor(comp).toarray())
            M = self._disk_ncc_matrix(subproblem, ncc, operand, place)
            op_mats = operand_expression_matrices(operand, subproblem, vars,
                                                  **kw)
            return {var: M @ mat for var, mat in op_mats.items()}
        M = self._assemble_ncc_matrix(subproblem, ncc, operand, tensor_factor)
        op_mats = operand_expression_matrices(operand, subproblem, vars, **kw)
        return {var: M @ mat for var, mat in op_mats.items()}


class CrossProduct(ProductBase):
    """3D cross product (dedalus_tpu/core/arithmetic.py:1822; reference:
    core/arithmetic.py:677)."""

    name = "Cross"
    natural_layout = "g"

    def __init__(self, a, b):
        if a.tensorsig[-1].dim != 3 or b.tensorsig[0].dim != 3:
            raise ValueError("CrossProduct requires 3D vectors.")
        super().__init__(a, b)

    def _build_metadata(self):
        a, b = self.args
        self.tensorsig = tuple(a.tensorsig)
        self.domain = _product_domain(self.dist, [a, b])
        self.dtype = _promote_dtype(self.args)

    def ev_impl(self, ctx):
        a, b = self.args
        da = ev(a, ctx, "g")
        db = ev(b, ctx, "g")
        out = torch.linalg.cross(da, db, dim=0)
        # Left-handed component orderings (spherical (phi, theta, r)) flip
        # the orientation (reference: core/coords.py right_handed flags).
        if not getattr(a.tensorsig[-1], "right_handed", True):
            out = -out
        return out

    def _coord_bilinear_map(self, ncc, operand, ncc_index):
        if len(ncc.tshape) != 1 or len(operand.tshape) != 1:
            raise NonlinearOperatorError(
                "LHS cross products support vector x vector only.")
        eps = np.zeros((3, 3, 3))
        for i, j, k in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
            eps[i, j, k] = 1.0
            eps[i, k, j] = -1.0
        if not getattr(self.tensorsig[-1], "right_handed", True):
            eps = -eps
        if ncc_index == 0:
            return eps                       # out_i = eps_ijk ncc_j op_k
        return np.swapaxes(eps, 1, 2)        # out_i = eps_ijk op_j ncc_k

    def expression_matrices(self, subproblem, vars, **kw):
        """LHS cross with an NCC factor (e.g. the Coriolis term
        cross(ez, u) of rotating convection,
        reference: examples/evp_shell_rotating_convection)."""
        ncc_index, ncc, operand = self._split_ncc(vars, subproblem.layout)
        if self._spherical_regularity_basis(ncc) is not None:
            M = self._spherical_ncc_matrix(subproblem, ncc, operand,
                                           ncc_index)
            op_mats = operand_expression_matrices(operand, subproblem, vars,
                                                  **kw)
            return {var: M @ mat for var, mat in op_mats.items()}
        # Cartesian / interval bases: per-axis path with the Levi-Civita
        # tensor factor selecting each NCC component's action
        T = self._coord_bilinear_map(ncc, operand, ncc_index)

        def tensor_factor(comp):
            j = comp[0] if comp else 0
            return sparsify(sp.csr_matrix(T[:, j, :]), 1e-14)

        M = self._assemble_ncc_matrix(subproblem, ncc, operand, tensor_factor)
        op_mats = operand_expression_matrices(operand, subproblem, vars, **kw)
        return {var: M @ mat for var, mat in op_mats.items()}


class Power(Future):
    """Scalar field to a constant power (dedalus_tpu/core/arithmetic.py:
    1888), pointwise on the grid."""

    name = "Pow"
    natural_layout = "g"

    def __init__(self, base, exponent):
        if not _is_scalar(exponent):
            raise ValueError("Exponent must be a scalar constant.")
        self.exponent = exponent
        super().__init__(base)

    def rebuild(self, new_args):
        return Power(new_args[0], self.exponent)

    def _build_metadata(self):
        base = self.args[0]
        if base.tensorsig:
            raise ValueError("Power requires scalar fields.")
        self.domain = base.domain
        self.tensorsig = ()
        self.dtype = base.dtype

    def __repr__(self):
        return f"({self.args[0]}**{self.exponent})"

    def ev_impl(self, ctx):
        return ev(self.args[0], ctx, "g") ** self.exponent

    def frechet_differential(self, variables, perturbations):
        base = self.args[0]
        d = base.frechet_differential(variables, perturbations)
        if _is_scalar(d) and d == 0:
            return 0
        n = self.exponent
        return n * Power(base, n - 1) * d


# parseables
from .operators import parseables  # noqa: E402
parseables["dot"] = DotProduct
parseables["cross"] = CrossProduct
