"""Typed configuration tree.

Mirrors the reference solver's JSON configuration API (reference:
palace/utils/configfile.hpp:57-1119, scripts/schema/config-schema.json):
five sections Problem / Model / Domains / Boundaries / Solver, with the
same keys, defaults, and validation semantics.  Unknown keys are an error
(the reference validates against a draft-07 JSON Schema with
additionalProperties disabled).

Copied from palace_tpu/config/schema.py, imports pointed at palace_torch;
one change: Solver.Device defaults to "GPU".
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import List, Optional


class ConfigError(ValueError):
    pass


def _ctx(where: str, key: str) -> str:
    return f"{where}.{key}" if where else key


class _Node(dict):
    """Wrapper over a JSON object that tracks consumed keys."""

    def __init__(self, data: dict, where: str):
        super().__init__(data)
        self.where = where
        self._used = set()

    def get_value(self, key, default=None, required=False, types=None):
        if key not in self:
            if required:
                raise ConfigError(f"missing required key '{_ctx(self.where, key)}'")
            return default
        self._used.add(key)
        v = self[key]
        if types is not None and not isinstance(v, types):
            raise ConfigError(
                f"'{_ctx(self.where, key)}' has invalid type {type(v).__name__}"
            )
        return v

    def child(self, key, required=False):
        v = self.get_value(key, required=required)
        if v is None:
            return None
        if not isinstance(v, dict):
            raise ConfigError(f"'{_ctx(self.where, key)}' must be an object")
        return _Node(v, _ctx(self.where, key))

    def child_list(self, key):
        v = self.get_value(key)
        if v is None:
            return []
        if not isinstance(v, list):
            raise ConfigError(f"'{_ctx(self.where, key)}' must be an array")
        out = []
        for i, item in enumerate(v):
            if not isinstance(item, dict):
                raise ConfigError(f"'{_ctx(self.where, key)}[{i}]' must be an object")
            out.append(_Node(item, f"{_ctx(self.where, key)}[{i}]"))
        return out

    def check_consumed(self):
        extra = set(self.keys()) - self._used
        if extra:
            raise ConfigError(
                f"unknown key(s) {sorted(extra)} in '{self.where or '<root>'}'"
            )


def _int_list(node: _Node, key, default=(), required=False) -> List[int]:
    v = node.get_value(key, default=None, required=required)
    if v is None:
        return list(default)
    if not isinstance(v, list) or not all(isinstance(x, int) for x in v):
        raise ConfigError(f"'{_ctx(node.where, key)}' must be an integer array")
    return list(v)


def _float_list(node: _Node, key, default=(), required=False, length=None) -> List[float]:
    v = node.get_value(key, default=None, required=required)
    if v is None:
        return list(default)
    if not isinstance(v, list) or not all(isinstance(x, (int, float)) for x in v):
        raise ConfigError(f"'{_ctx(node.where, key)}' must be a numeric array")
    if length is not None and len(v) != length:
        raise ConfigError(f"'{_ctx(node.where, key)}' must have length {length}")
    return [float(x) for x in v]


def _enum(node: _Node, key, enum_cls, default):
    v = node.get_value(key)
    if v is None:
        return default
    try:
        return enum_cls(v)
    except ValueError:
        raise ConfigError(
            f"'{_ctx(node.where, key)}' must be one of "
            f"{[e.value for e in enum_cls]}, got '{v}'"
        )


# ---------------------------------------------------------------------------
# Problem


class ProblemType(enum.Enum):
    DRIVEN = "Driven"
    EIGENMODE = "Eigenmode"
    ELECTROSTATIC = "Electrostatic"
    MAGNETOSTATIC = "Magnetostatic"
    TRANSIENT = "Transient"
    BOUNDARY_MODE = "BoundaryMode"


@dataclass
class OutputFormats:
    paraview: bool = True
    grid_function: bool = False

    @staticmethod
    def parse(node: Optional[_Node]) -> "OutputFormats":
        if node is None:
            return OutputFormats()
        out = OutputFormats(
            paraview=bool(node.get_value("Paraview", True)),
            grid_function=bool(node.get_value("GridFunction", False)),
        )
        node.check_consumed()
        return out


@dataclass
class ProblemConfig:
    type: ProblemType = ProblemType.DRIVEN
    verbose: int = 1
    output: str = "postpro"
    output_formats: OutputFormats = field(default_factory=OutputFormats)

    @staticmethod
    def parse(node: _Node) -> "ProblemConfig":
        out = ProblemConfig(
            type=_enum(node, "Type", ProblemType, ProblemType.DRIVEN),
            verbose=int(node.get_value("Verbose", 1)),
            output=str(node.get_value("Output", "postpro")),
            output_formats=OutputFormats.parse(node.child("OutputFormats")),
        )
        node.check_consumed()
        return out


# ---------------------------------------------------------------------------
# Model


@dataclass
class BoxRefinement:
    ref_levels: int = 0
    bbmin: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    bbmax: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])


@dataclass
class SphereRefinement:
    ref_levels: int = 0
    r: float = 0.0
    center: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])


@dataclass
class RefinementConfig:
    tol: float = 1.0e-2
    max_it: int = 0
    max_size: int = 0
    nonconformal: bool = True
    max_nc_levels: int = 1
    update_fraction: float = 0.7
    maximum_imbalance: float = 1.1
    save_adapt_iterations: bool = True
    save_adapt_mesh: bool = False
    uniform_ref_levels: int = 0
    ser_uniform_ref_levels: int = 0
    boxes: List[BoxRefinement] = field(default_factory=list)
    spheres: List[SphereRefinement] = field(default_factory=list)

    @staticmethod
    def parse(node: Optional[_Node]) -> "RefinementConfig":
        if node is None:
            return RefinementConfig()
        out = RefinementConfig(
            tol=float(node.get_value("Tol", 1.0e-2)),
            max_it=int(node.get_value("MaxIts", 0)),
            max_size=int(node.get_value("MaxSize", 0)),
            nonconformal=bool(node.get_value("Nonconformal", True)),
            max_nc_levels=int(node.get_value("MaxNCLevels", 1)),
            update_fraction=float(node.get_value("UpdateFraction", 0.7)),
            maximum_imbalance=float(node.get_value("MaximumImbalance", 1.1)),
            save_adapt_iterations=bool(node.get_value("SaveAdaptIterations", True)),
            save_adapt_mesh=bool(node.get_value("SaveAdaptMesh", False)),
            uniform_ref_levels=int(node.get_value("UniformLevels", 0)),
            ser_uniform_ref_levels=int(node.get_value("SerialUniformLevels", 0)),
        )
        for b in node.child_list("Boxes"):
            out.boxes.append(
                BoxRefinement(
                    ref_levels=int(b.get_value("Levels", 0)),
                    bbmin=_float_list(b, "BoundingBoxMin", required=True, length=3),
                    bbmax=_float_list(b, "BoundingBoxMax", required=True, length=3),
                )
            )
            b.check_consumed()
        for s in node.child_list("Spheres"):
            out.spheres.append(
                SphereRefinement(
                    ref_levels=int(s.get_value("Levels", 0)),
                    r=float(s.get_value("Radius", required=True)),
                    center=_float_list(s, "Center", required=True, length=3),
                )
            )
            s.check_consumed()
        node.check_consumed()
        return out


@dataclass
class ModelConfig:
    mesh: str = ""
    L0: float = 1.0e-6
    Lc: float = -1.0
    remove_curvature: bool = False
    make_simplex: bool = False
    make_hex: bool = False
    reorder_elements: bool = False
    clean_unused_elements: bool = True
    crack_bdr_elements: bool = True
    refine_crack_elements: bool = True
    crack_displ_factor: float = 1.0e-12
    add_bdr_elements: bool = True
    partitioning: str = ""
    refinement: RefinementConfig = field(default_factory=RefinementConfig)

    @staticmethod
    def parse(node: _Node) -> "ModelConfig":
        out = ModelConfig(
            mesh=str(node.get_value("Mesh", required=True)),
            L0=float(node.get_value("L0", 1.0e-6)),
            Lc=float(node.get_value("Lc", -1.0)),
            remove_curvature=bool(node.get_value("RemoveCurvature", False)),
            make_simplex=bool(node.get_value("MakeSimplex", False)),
            make_hex=bool(node.get_value("MakeHexahedral", False)),
            reorder_elements=bool(node.get_value("ReorderElements", False)),
            clean_unused_elements=bool(node.get_value("CleanUnusedElements", True)),
            crack_bdr_elements=bool(node.get_value("CrackBdrElements", True)),
            refine_crack_elements=bool(node.get_value("RefineCrackElements", True)),
            crack_displ_factor=float(node.get_value("CrackDisplacementFactor", 1.0e-12)),
            add_bdr_elements=bool(node.get_value("AddInterfaceBdrElements", True)),
            partitioning=str(node.get_value("Partitioning", "")),
            refinement=RefinementConfig.parse(node.child("Refinement")),
        )
        node.check_consumed()
        return out


# ---------------------------------------------------------------------------
# Domains


def _tensor_prop(node: _Node, key, default_scalar: float):
    """Material property: scalar or length-3 array (diagonal in material axes)."""
    v = node.get_value(key)
    if v is None:
        return [default_scalar] * 3
    if isinstance(v, (int, float)):
        return [float(v)] * 3
    if isinstance(v, list) and all(isinstance(x, (int, float)) for x in v) and len(v) == 3:
        return [float(x) for x in v]
    raise ConfigError(f"'{_ctx(node.where, key)}' must be a number or 3-array")


@dataclass
class MaterialConfig:
    attributes: List[int] = field(default_factory=list)
    permeability: List[float] = field(default_factory=lambda: [1.0] * 3)
    permittivity: List[float] = field(default_factory=lambda: [1.0] * 3)
    loss_tan: List[float] = field(default_factory=lambda: [0.0] * 3)
    conductivity: List[float] = field(default_factory=lambda: [0.0] * 3)
    london_depth: float = 0.0
    material_axes: Optional[List[List[float]]] = None

    @staticmethod
    def parse(node: _Node) -> "MaterialConfig":
        axes = node.get_value("MaterialAxes")
        out = MaterialConfig(
            attributes=_int_list(node, "Attributes", required=True),
            permeability=_tensor_prop(node, "Permeability", 1.0),
            permittivity=_tensor_prop(node, "Permittivity", 1.0),
            loss_tan=_tensor_prop(node, "LossTan", 0.0),
            conductivity=_tensor_prop(node, "Conductivity", 0.0),
            london_depth=float(node.get_value("LondonDepth", 0.0)),
            material_axes=axes,
        )
        node.check_consumed()
        return out


@dataclass
class ProbeConfig:
    index: int = 0
    center: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])


@dataclass
class EnergyPostConfig:
    index: int = 0
    attributes: List[int] = field(default_factory=list)


@dataclass
class CurrentDipoleConfig:
    index: int = 0
    moment: float = 1.0
    center: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    direction: List[float] = field(default_factory=lambda: [0.0, 0.0, 1.0])


@dataclass
class DomainsConfig:
    materials: List[MaterialConfig] = field(default_factory=list)
    current_dipoles: List[CurrentDipoleConfig] = field(default_factory=list)
    probes: List[ProbeConfig] = field(default_factory=list)
    energies: List[EnergyPostConfig] = field(default_factory=list)

    @staticmethod
    def parse(node: _Node) -> "DomainsConfig":
        out = DomainsConfig()
        for m in node.child_list("Materials"):
            out.materials.append(MaterialConfig.parse(m))
        for d in node.child_list("CurrentDipole"):
            out.current_dipoles.append(
                CurrentDipoleConfig(
                    index=int(d.get_value("Index", required=True)),
                    moment=float(d.get_value("Moment", 1.0)),
                    center=_float_list(d, "Center", required=True, length=3),
                    direction=_float_list(d, "Direction", required=True, length=3),
                )
            )
            d.check_consumed()
        post = node.child("Postprocessing")
        if post is not None:
            for p in post.child_list("Probe"):
                out.probes.append(
                    ProbeConfig(
                        index=int(p.get_value("Index", required=True)),
                        center=_float_list(p, "Center", required=True, length=3),
                    )
                )
                p.check_consumed()
            for e in post.child_list("Energy"):
                out.energies.append(
                    EnergyPostConfig(
                        index=int(e.get_value("Index", required=True)),
                        attributes=_int_list(e, "Attributes", required=True),
                    )
                )
                e.check_consumed()
            post.check_consumed()
        node.check_consumed()
        return out


# ---------------------------------------------------------------------------
# Boundaries


@dataclass
class TerminalConfig:
    index: int = 0
    attributes: List[int] = field(default_factory=list)


@dataclass
class SurfaceCurrentConfig:
    index: int = 0
    attributes: List[int] = field(default_factory=list)
    direction: Optional[List[float]] = None
    # Multi-element surface currents (list of {Attributes, Direction}).
    elements: List[dict] = field(default_factory=list)


@dataclass
class ImpedanceConfig:
    attributes: List[int] = field(default_factory=list)
    Rs: float = 0.0
    Ls: float = 0.0
    Cs: float = 0.0


@dataclass
class AbsorbingConfig:
    attributes: List[int] = field(default_factory=list)
    order: int = 1


@dataclass
class ConductivityConfig:
    attributes: List[int] = field(default_factory=list)
    sigma: float = 0.0
    mu_r: float = 1.0
    h: float = 0.0
    external: bool = False


@dataclass
class LumpedPortElement:
    attributes: List[int] = field(default_factory=list)
    direction: str | List[float] = "+X"
    coordinate_center: Optional[List[float]] = None


@dataclass
class LumpedPortConfig:
    index: int = 0
    R: float = 0.0
    L: float = 0.0
    C: float = 0.0
    Rs: float = 0.0
    Ls: float = 0.0
    Cs: float = 0.0
    excitation: int = 0
    active: bool = True
    elements: List[LumpedPortElement] = field(default_factory=list)


@dataclass
class WavePortConfig:
    index: int = 0
    attributes: List[int] = field(default_factory=list)
    mode: int = 1
    offset: float = 0.0
    solver_type: str = "Default"
    excitation: int = 0
    active: bool = True
    max_its: int = 45
    ksp_tol: float = 1.0e-8
    eig_tol: float = 1.0e-6
    verbose: int = 0
    voltage_path: Optional[List[List[float]]] = None
    n_samples: int = 100


@dataclass
class SurfaceFluxConfig:
    index: int = 0
    attributes: List[int] = field(default_factory=list)
    type: str = "Electric"  # Electric | Magnetic | Power
    two_sided: bool = False
    center: Optional[List[float]] = None


@dataclass
class InterfaceDielectricConfig:
    index: int = 0
    attributes: List[int] = field(default_factory=list)
    type: str = "Default"  # Default | MA | MS | SA
    thickness: float = 0.0
    permittivity: float = 0.0
    loss_tan: float = 0.0


@dataclass
class PeriodicConfig:
    donor_attributes: List[int] = field(default_factory=list)
    receiver_attributes: List[int] = field(default_factory=list)
    translation: Optional[List[float]] = None
    affine_transform: Optional[List[float]] = None
    floquet_wave_vector: Optional[List[float]] = None


@dataclass
class FarfieldPostConfig:
    """Far-field radiation pattern postprocessing (Stratton-Chu)."""

    attributes: List[int] = field(default_factory=list)
    n_sample: int = 0
    theta_phis: List[List[float]] = field(default_factory=list)


@dataclass
class SurfaceVoltageConfig:
    """Line-integral voltage postprocessing (GSLIB-style path integral)."""

    index: int = 0
    voltage_path: List[List[float]] = field(default_factory=list)
    n_samples: int = 100


@dataclass
class SurfaceImpedancePostConfig:
    index: int = 0
    voltage_path: List[List[float]] = field(default_factory=list)
    n_samples: int = 100


@dataclass
class BoundariesConfig:
    pec: List[int] = field(default_factory=list)
    pmc: List[int] = field(default_factory=list)
    ground: List[int] = field(default_factory=list)
    zero_charge: List[int] = field(default_factory=list)
    terminals: List[TerminalConfig] = field(default_factory=list)
    surface_currents: List[SurfaceCurrentConfig] = field(default_factory=list)
    impedances: List[ImpedanceConfig] = field(default_factory=list)
    absorbing: Optional[AbsorbingConfig] = None
    conductivities: List[ConductivityConfig] = field(default_factory=list)
    lumped_ports: List[LumpedPortConfig] = field(default_factory=list)
    wave_ports: List[WavePortConfig] = field(default_factory=list)
    wave_port_pec: List[int] = field(default_factory=list)
    periodic: List[PeriodicConfig] = field(default_factory=list)
    floquet_wave_vector: Optional[List[float]] = None
    floquet_reference_frequency: float = 0.0
    floquet_ports: List[dict] = field(default_factory=list)
    # Postprocessing
    surface_fluxes: List[SurfaceFluxConfig] = field(default_factory=list)
    dielectrics: List[InterfaceDielectricConfig] = field(default_factory=list)
    farfield: Optional[FarfieldPostConfig] = None
    voltages: List[SurfaceVoltageConfig] = field(default_factory=list)
    impedance_posts: List[SurfaceImpedancePostConfig] = field(default_factory=list)

    @staticmethod
    def parse(node: Optional[_Node]) -> "BoundariesConfig":
        out = BoundariesConfig()
        if node is None:
            return out

        def attr_block(key):
            c = node.child(key)
            if c is None:
                return []
            a = _int_list(c, "Attributes", required=True)
            c.check_consumed()
            return a

        out.pec = attr_block("PEC")
        out.pmc = attr_block("PMC")
        out.ground = attr_block("Ground")
        out.zero_charge = attr_block("ZeroCharge")
        out.wave_port_pec = attr_block("WavePortPEC")

        for t in node.child_list("Terminal"):
            out.terminals.append(
                TerminalConfig(
                    index=int(t.get_value("Index", required=True)),
                    attributes=_int_list(t, "Attributes", required=True),
                )
            )
            t.check_consumed()

        for s in node.child_list("SurfaceCurrent"):
            sc = SurfaceCurrentConfig(index=int(s.get_value("Index", required=True)))
            if "Elements" in s:
                for e in s.child_list("Elements"):
                    sc.elements.append(
                        dict(
                            attributes=_int_list(e, "Attributes", required=True),
                            direction=e.get_value("Direction", required=True),
                        )
                    )
                    e.check_consumed()
            else:
                sc.attributes = _int_list(s, "Attributes", required=True)
                sc.direction = s.get_value("Direction", required=True)
            s.check_consumed()
            out.surface_currents.append(sc)

        for s in node.child_list("Impedance"):
            out.impedances.append(
                ImpedanceConfig(
                    attributes=_int_list(s, "Attributes", required=True),
                    Rs=float(s.get_value("Rs", 0.0)),
                    Ls=float(s.get_value("Ls", 0.0)),
                    Cs=float(s.get_value("Cs", 0.0)),
                )
            )
            s.check_consumed()

        ab = node.child("Absorbing")
        if ab is not None:
            out.absorbing = AbsorbingConfig(
                attributes=_int_list(ab, "Attributes", required=True),
                order=int(ab.get_value("Order", 1)),
            )
            ab.check_consumed()

        for s in node.child_list("Conductivity"):
            out.conductivities.append(
                ConductivityConfig(
                    attributes=_int_list(s, "Attributes", required=True),
                    sigma=float(s.get_value("Conductivity", required=True)),
                    mu_r=float(s.get_value("Permeability", 1.0)),
                    h=float(s.get_value("Thickness", 0.0)),
                    external=bool(s.get_value("External", False)),
                )
            )
            s.check_consumed()

        for p in node.child_list("LumpedPort") + node.child_list("Port"):
            lp = LumpedPortConfig(
                index=int(p.get_value("Index", required=True)),
                R=float(p.get_value("R", 0.0)),
                L=float(p.get_value("L", 0.0)),
                C=float(p.get_value("C", 0.0)),
                Rs=float(p.get_value("Rs", 0.0)),
                Ls=float(p.get_value("Ls", 0.0)),
                Cs=float(p.get_value("Cs", 0.0)),
                excitation=int(
                    p.get_value("Excitation", 0)
                    if not isinstance(p.get_value("Excitation", 0), bool)
                    else (1 if p["Excitation"] else 0)
                ),
                active=bool(p.get_value("Active", True)),
            )
            if "Elements" in p:
                for e in p.child_list("Elements"):
                    lp.elements.append(
                        LumpedPortElement(
                            attributes=_int_list(e, "Attributes", required=True),
                            direction=e.get_value("Direction", required=True),
                            coordinate_center=e.get_value("CoordinateCenter"),
                        )
                    )
                    e.check_consumed()
            else:
                lp.elements.append(
                    LumpedPortElement(
                        attributes=_int_list(p, "Attributes", required=True),
                        direction=p.get_value("Direction", "+X"),
                        coordinate_center=p.get_value("CoordinateCenter"),
                    )
                )
            p.check_consumed()
            out.lumped_ports.append(lp)

        for p in node.child_list("WavePort"):
            exc = p.get_value("Excitation", 0)
            out.wave_ports.append(
                WavePortConfig(
                    index=int(p.get_value("Index", required=True)),
                    attributes=_int_list(p, "Attributes", required=True),
                    mode=int(p.get_value("Mode", 1)),
                    offset=float(p.get_value("Offset", 0.0)),
                    solver_type=str(p.get_value("SolverType", "Default")),
                    excitation=int(exc if not isinstance(exc, bool) else (1 if exc else 0)),
                    active=bool(p.get_value("Active", True)),
                    max_its=int(p.get_value("MaxIts", 45)),
                    ksp_tol=float(p.get_value("KSPTol", 1.0e-8)),
                    eig_tol=float(p.get_value("EigenTol", 1.0e-6)),
                    verbose=int(p.get_value("Verbose", 0)),
                    voltage_path=p.get_value("VoltagePath"),
                    n_samples=int(p.get_value("NSamples", 100)),
                )
            )
            p.check_consumed()

        per = node.get_value("Periodic")
        if isinstance(per, dict):
            # Object form: global Floquet wave vector + boundary pairs.
            pn = _Node(per, _ctx(node.where, "Periodic"))
            node._used.add("Periodic")
            out.floquet_wave_vector = pn.get_value("FloquetWaveVector")
            out.floquet_reference_frequency = float(
                pn.get_value("FloquetReferenceFrequency", 0.0)
            )
            for p in pn.child_list("BoundaryPairs"):
                out.periodic.append(
                    PeriodicConfig(
                        donor_attributes=_int_list(p, "DonorAttributes", required=True),
                        receiver_attributes=_int_list(
                            p, "ReceiverAttributes", required=True
                        ),
                        translation=p.get_value("Translation"),
                        affine_transform=p.get_value("AffineTransformation"),
                    )
                )
                p.check_consumed()
            pn.check_consumed()
        else:
            for p in node.child_list("Periodic"):
                out.periodic.append(
                    PeriodicConfig(
                        donor_attributes=_int_list(p, "DonorAttributes", required=True),
                        receiver_attributes=_int_list(
                            p, "ReceiverAttributes", required=True
                        ),
                        translation=p.get_value("Translation"),
                        affine_transform=p.get_value("AffineTransformation"),
                        floquet_wave_vector=p.get_value("FloquetWaveVector"),
                    )
                )
                p.check_consumed()

        for p in node.child_list("FloquetPort"):
            out.floquet_ports.append(dict(p))

        post = node.child("Postprocessing")
        if post is not None:
            for s in post.child_list("SurfaceFlux"):
                out.surface_fluxes.append(
                    SurfaceFluxConfig(
                        index=int(s.get_value("Index", required=True)),
                        attributes=_int_list(s, "Attributes", required=True),
                        type=str(s.get_value("Type", "Electric")),
                        two_sided=bool(s.get_value("TwoSided", False)),
                        center=s.get_value("Center"),
                    )
                )
                s.check_consumed()
            for s in post.child_list("Dielectric"):
                out.dielectrics.append(
                    InterfaceDielectricConfig(
                        index=int(s.get_value("Index", required=True)),
                        attributes=_int_list(s, "Attributes", required=True),
                        type=str(s.get_value("Type", "Default")),
                        thickness=float(s.get_value("Thickness", required=True)),
                        permittivity=float(s.get_value("Permittivity", required=True)),
                        loss_tan=float(s.get_value("LossTan", 0.0)),
                    )
                )
                s.check_consumed()
            ff = post.child("FarField")
            if ff is not None:
                out.farfield = FarfieldPostConfig(
                    attributes=_int_list(ff, "Attributes", required=True),
                    n_sample=int(ff.get_value("NSample", 0)),
                    theta_phis=ff.get_value("ThetaPhis", []),
                )
                ff.check_consumed()
            for s in post.child_list("Voltage"):
                out.voltages.append(
                    SurfaceVoltageConfig(
                        index=int(s.get_value("Index", required=True)),
                        voltage_path=s.get_value("VoltagePath", required=True),
                        n_samples=int(s.get_value("NSamples", 100)),
                    )
                )
                s.check_consumed()
            for s in post.child_list("Impedance"):
                out.impedance_posts.append(
                    SurfaceImpedancePostConfig(
                        index=int(s.get_value("Index", required=True)),
                        voltage_path=s.get_value("VoltagePath", required=True),
                        n_samples=int(s.get_value("NSamples", 100)),
                    )
                )
                s.check_consumed()
            post.check_consumed()

        node.check_consumed()
        return out


# ---------------------------------------------------------------------------
# Solver


@dataclass
class ElectrostaticSolverConfig:
    n_post: int = 0


@dataclass
class MagnetostaticSolverConfig:
    n_post: int = 0


@dataclass
class EigenSolverConfig:
    target: float = 0.0  # [GHz]
    target_upper: float = -1.0  # [GHz]; default 3 * target
    tol: float = 1.0e-6
    max_it: int = -1
    max_size: int = -1
    n: int = 1
    n_post: int = 0
    scale: bool = True
    init_v0: bool = True
    init_v0_const: bool = False
    mass_orthog: bool = False
    type: str = "Default"


@dataclass
class DrivenSolverConfig:
    samples: List[dict] = field(default_factory=list)
    min_freq: Optional[float] = None
    max_freq: Optional[float] = None
    freq_step: Optional[float] = None
    save_step: int = 0
    save_indices: List[int] = field(default_factory=list)
    save_freqs: List[float] = field(default_factory=list)
    restart: int = 1
    adaptive_tol: float = 0.0
    adaptive_max_size: int = 20
    adaptive_memory: int = 2
    adaptive_circuit_synthesis: bool = False


@dataclass
class TransientSolverConfig:
    type: str = "Default"
    excitation: str = "Sinusoidal"
    pulse_f: float = 0.0  # [GHz]
    pulse_tau: float = 0.0  # [ns]
    max_t: float = 1.0  # [ns]
    delta_t: float = 1.0e-2  # [ns]
    delta_post: int = 0
    order: int = 2
    rel_tol: float = 1e-4
    abs_tol: float = 1e-9


@dataclass
class BoundaryModeSolverConfig:
    freq: float = 1.0
    n: int = 1
    n_post: int = 0
    target: float = 0.0
    tol: float = 1.0e-6
    max_size: int = -1
    type: str = "Default"
    attributes: List[int] = field(default_factory=list)


@dataclass
class LinearSolverConfig:
    type: str = "Default"
    ksp_type: str = "Default"
    tol: float = 1.0e-6
    max_its: int = 100
    max_size: int = -1
    initial_guess: bool = True
    # Multigrid options.
    mg_max_levels: int = 100
    mg_coarsening: str = "Logarithmic"
    mg_cycle_its: int = 1
    mg_smooth_its: int = 1
    mg_smooth_order: int = -1
    mg_use_aux: bool = True
    # Misc.
    pc_mat_real: bool = False
    pc_mat_shifted: bool = False
    pc_side: str = "Default"
    column_ordering: str = "Default"
    gs_orthog: str = "MGS"
    complex_coarse_solve: bool = False
    precision: str = "Default"  # Default | Single | Double (TPU-specific extension)


@dataclass
class SolverConfig:
    order: int = 1
    partial_assembly_order: int = 1
    # Reference default is q_order_jac = FALSE (utils/configfile.hpp:1077):
    # plain q = 2p, under-integrating curved elements.
    quadrature_order_jac: bool = False
    quadrature_order_extra: int = 0
    # The port runs on the card unless the config asks for the CPU (the JAX
    # package defaults to "CPU").
    device: str = "GPU"
    electrostatic: ElectrostaticSolverConfig = field(
        default_factory=ElectrostaticSolverConfig
    )
    magnetostatic: MagnetostaticSolverConfig = field(
        default_factory=MagnetostaticSolverConfig
    )
    eigenmode: EigenSolverConfig = field(default_factory=EigenSolverConfig)
    driven: DrivenSolverConfig = field(default_factory=DrivenSolverConfig)
    transient: TransientSolverConfig = field(default_factory=TransientSolverConfig)
    boundary_mode: BoundaryModeSolverConfig = field(
        default_factory=BoundaryModeSolverConfig
    )
    linear: LinearSolverConfig = field(default_factory=LinearSolverConfig)

    @staticmethod
    def parse(node: _Node) -> "SolverConfig":
        out = SolverConfig(
            order=int(node.get_value("Order", 1)),
            partial_assembly_order=int(node.get_value("PartialAssemblyOrder", 1)),
            quadrature_order_jac=bool(node.get_value("QuadratureOrderJacobian", False)),
            quadrature_order_extra=int(node.get_value("QuadratureOrderExtra", 0)),
            device=str(node.get_value("Device", "GPU")),
        )
        es = node.child("Electrostatic")
        if es is not None:
            out.electrostatic = ElectrostaticSolverConfig(
                n_post=int(es.get_value("Save", 0))
            )
            es.check_consumed()
        ms = node.child("Magnetostatic")
        if ms is not None:
            out.magnetostatic = MagnetostaticSolverConfig(
                n_post=int(ms.get_value("Save", 0))
            )
            ms.check_consumed()
        em = node.child("Eigenmode")
        if em is not None:
            out.eigenmode = EigenSolverConfig(
                target=float(em.get_value("Target", 0.0)),
                target_upper=float(em.get_value("TargetUpper", -1.0)),
                tol=float(em.get_value("Tol", 1.0e-6)),
                max_it=int(em.get_value("MaxIts", -1)),
                max_size=int(em.get_value("MaxSize", -1)),
                n=int(em.get_value("N", 1)),
                n_post=int(em.get_value("Save", 0)),
                scale=bool(em.get_value("Scaling", True)),
                init_v0=bool(em.get_value("StartVector", True)),
                init_v0_const=bool(em.get_value("StartVectorConstant", False)),
                mass_orthog=bool(em.get_value("MassOrthogonal", False)),
                type=str(em.get_value("Type", "Default")),
            )
            # Accepted (contour-integral etc. options parsed but unused for now).
            em.get_value("ContourNPoints")
            em.check_consumed()
        dr = node.child("Driven")
        if dr is not None:
            samples = [dict(s) for s in dr.child_list("Samples")]
            out.driven = DrivenSolverConfig(
                samples=samples,
                min_freq=dr.get_value("MinFreq"),
                max_freq=dr.get_value("MaxFreq"),
                freq_step=dr.get_value("FreqStep"),
                save_step=int(dr.get_value("SaveStep", 0)),
                save_indices=_int_list(dr, "SaveIndices"),
                save_freqs=_float_list(dr, "Save"),
                restart=int(dr.get_value("Restart", 1)),
                adaptive_tol=float(dr.get_value("AdaptiveTol", 0.0)),
                adaptive_max_size=int(dr.get_value("AdaptiveMaxSamples", 20)),
                adaptive_memory=int(dr.get_value("AdaptiveMemory", 2)),
                adaptive_circuit_synthesis=bool(
                    dr.get_value("AdaptiveCircuitSynthesis", False)),
            )
            dr.check_consumed()
        tr = node.child("Transient")
        if tr is not None:
            out.transient = TransientSolverConfig(
                type=str(tr.get_value("Type", "Default")),
                excitation=str(tr.get_value("Excitation", required=True)),
                pulse_f=float(tr.get_value("ExcitationFreq", 0.0)),
                pulse_tau=float(tr.get_value("ExcitationWidth", 0.0)),
                max_t=float(tr.get_value("MaxTime", required=True)),
                delta_t=float(tr.get_value("TimeStep", required=True)),
                delta_post=int(tr.get_value("SaveStep", 0)),
                order=int(tr.get_value("Order", 2)),
                rel_tol=float(tr.get_value("RelTol", 1e-4)),
                abs_tol=float(tr.get_value("AbsTol", 1e-9)),
            )
            tr.check_consumed()
        bm = node.child("BoundaryMode")
        if bm is not None:
            out.boundary_mode = BoundaryModeSolverConfig(
                freq=float(bm.get_value("Freq", 1.0)),
                n=int(bm.get_value("N", 1)),
                n_post=int(bm.get_value("Save", 0)),
                target=float(bm.get_value("Target", 0.0)),
                tol=float(bm.get_value("Tol", 1.0e-6)),
                max_size=int(bm.get_value("MaxSize", -1)),
                type=str(bm.get_value("Type", "Default")),
                attributes=_int_list(bm, "Attributes"),
            )
            bm.check_consumed()
        ln = node.child("Linear")
        if ln is not None:
            out.linear = LinearSolverConfig(
                type=str(ln.get_value("Type", "Default")),
                ksp_type=str(ln.get_value("KSPType", "Default")),
                tol=float(ln.get_value("Tol", 1.0e-6)),
                max_its=int(ln.get_value("MaxIts", 100)),
                max_size=int(ln.get_value("MaxSize", -1)),
                initial_guess=bool(ln.get_value("InitialGuess", True)),
                mg_max_levels=int(ln.get_value("MGMaxLevels", 100)),
                mg_coarsening=str(ln.get_value("MGCoarsenType", "Logarithmic")),
                mg_cycle_its=int(ln.get_value("MGCycleIts", 1)),
                mg_smooth_its=int(ln.get_value("MGSmoothIts", 1)),
                mg_smooth_order=int(ln.get_value("MGSmoothOrder", -1)),
                mg_use_aux=bool(ln.get_value("MGAuxiliarySmoother", True)),
                pc_mat_real=bool(ln.get_value("PCMatReal", False)),
                pc_mat_shifted=bool(ln.get_value("PCMatShifted", False)),
                pc_side=str(ln.get_value("PCSide", "Default")),
                column_ordering=str(ln.get_value("ColumnOrdering", "Default")),
                gs_orthog=str(ln.get_value("GSOrthogonalization", "MGS")),
                complex_coarse_solve=bool(ln.get_value("ComplexCoarseSolve", False)),
                precision=str(ln.get_value("Precision", "Default")),
            )
            ln.check_consumed()
        node.check_consumed()
        return out


# ---------------------------------------------------------------------------
# Top level


@dataclass
class Config:
    problem: ProblemConfig
    model: ModelConfig
    domains: DomainsConfig
    boundaries: BoundariesConfig
    solver: SolverConfig

    @staticmethod
    def parse(data: dict) -> "Config":
        root = _Node(data, "")
        cfg = Config(
            problem=ProblemConfig.parse(root.child("Problem", required=True)),
            model=ModelConfig.parse(root.child("Model", required=True)),
            domains=DomainsConfig.parse(root.child("Domains", required=True)),
            boundaries=BoundariesConfig.parse(root.child("Boundaries")),
            solver=SolverConfig.parse(root.child("Solver", required=True)),
        )
        root.check_consumed()
        cfg.validate()
        return cfg

    def validate(self):
        pt = self.problem.type
        if pt is ProblemType.ELECTROSTATIC and not (
            self.boundaries.terminals or self.boundaries.ground
        ):
            raise ConfigError("electrostatic problems require Terminal boundaries")
        if pt is ProblemType.MAGNETOSTATIC and not self.boundaries.surface_currents:
            raise ConfigError("magnetostatic problems require SurfaceCurrent boundaries")
        idxs = [t.index for t in self.boundaries.terminals]
        if len(idxs) != len(set(idxs)):
            raise ConfigError("duplicate Terminal indices")

    def resolved_dict(self) -> dict:
        """Return the fully-defaulted configuration (for *_resolved.json echo,
        reference: palace/utils/iodata.hpp:58-71)."""

        def conv(obj):
            if dataclasses.is_dataclass(obj):
                return {
                    f.name: conv(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)
                }
            if isinstance(obj, enum.Enum):
                return obj.value
            if isinstance(obj, (list, tuple)):
                return [conv(x) for x in obj]
            if isinstance(obj, dict):
                return {k: conv(v) for k, v in obj.items()}
            return obj

        return conv(self)
