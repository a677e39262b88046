"""Mock-survey simulation: priors, IGM attenuation, survey synthesis.

Port of `frankenz_tpu.sim`: host sampling as in the JAX package, flux
synthesis in torch on the card.
"""

from .catalog import make_sdss_mock, sdss_model_grid  # noqa: F401
from .igm import madau_tau, madau_teff  # noqa: F401
from .priors import (  # noqa: F401
    BPZPrior,
    bpz_prior,
    bpz_pt_m,
    bpz_pz_tm,
    pmag,
)
from .survey import (  # noqa: F401
    IGM_CURVES,
    PRIORS,
    SURVEYS,
    TEMPLATE_LIBRARIES,
    MockSurvey,
    draw_mag,
    draw_redshift_given_type_mag,
    draw_redshifts,
    draw_type_given_mag,
    draw_types,
    draw_ztm,
    mag_err,
)
