"""Physical constants (CGS) that the port's parser and kernels use; the
values are those of the JAX package's ``constants.py``."""

#: Boltzmann constant [erg/K]
BOLTZMANN = 1.380649e-16
#: Avogadro's number [1/mol]
AVOGADRO = 6.02214076e23
#: universal gas constant [erg/(mol K)]
R_GAS = BOLTZMANN * AVOGADRO
#: universal gas constant [cal/(mol K)]: activation energies are cal/mol
R_CAL = 1.987204258640832
#: standard atmosphere [dyne/cm^2]
P_ATM = 1.01325e6
#: standard temperature [K]
T_STD = 298.15
#: calories per joule
CAL_PER_JOULE = 1.0 / 4.184
#: erg per calorie
ERG_PER_CAL = 4.184e7
#: the reference's names
R_GAS_CAL = R_CAL
P_TORRS = P_ATM / 760.0
ERGS_PER_JOULE = 1.0e7
JOULES_PER_CALORIE = 1.0 / CAL_PER_JOULE
ERGS_PER_CALORIE = ERG_PER_CAL


class Air:
    """Canonical air recipes, upper-case species symbols: lists of
    (species symbol, fraction)."""

    @staticmethod
    def X() -> list:
        return [("O2", 0.21), ("N2", 0.79)]

    @staticmethod
    def Y() -> list:
        return [("O2", 0.23), ("N2", 0.77)]


class air:
    """Air recipes with lower-case species symbols."""

    @staticmethod
    def X() -> list:
        return [("o2", 0.21), ("n2", 0.79)]

    @staticmethod
    def Y() -> list:
        return [("o2", 0.23), ("n2", 0.77)]


def water_heat_vaporization(temperature: float) -> float:
    """Latent heat of vaporization of water [erg/g] at ``temperature`` [K]
    (Watson-style correlation anchored at the normal boiling point; 0
    above the critical point, 647.096 K)."""
    import math
    t_crit = 647.096
    if temperature >= t_crit:
        return 0.0
    h_vap_nbp = 2256.4e7  # erg/g
    t_nbp = 373.15
    tr = (t_crit - temperature) / (t_crit - t_nbp)
    return h_vap_nbp * math.pow(max(tr, 0.0), 0.38)
