"""Numerical operations: likelihood, KDE, summaries, the fused route and
the photometry transforms."""

from .fused import (  # noqa: F401
    FusedCdfFallback,
    fused_fit_pdf,
    fused_route,
    kernels_available,
)
from .kde import (  # noqa: F401
    PDFDict,
    gauss_kde,
    gauss_kde_dict,
    gaussian,
    gaussian_bin,
    kde_stack,
    kde_stack_gathered,
    kde_stack_gathered_dict,
    kernel_matrix,
    kernel_matrix_dict,
    norm_rows,
    pack_label_spec,
    resolve_kde_opts,
    threshold_weights,
)
from .likelihood import (  # noqa: F401
    LoglikeResult,
    LogprobResult,
    clean_data,
    loglike,
    loglike_fixed,
    loglike_free,
    logprob,
)
from .summarize import (  # noqa: F401
    SUMMARY_NCOLS,
    PDFSummary,
    PointEstimate,
    loss_kernel_matrix,
    pdfs_resample,
    pdfs_summarize,
    summary_stream_step,
    unpack_summary,
)
from .transforms import (  # noqa: F401
    inv_luptitude,
    inv_magnitude,
    luptitude,
    magnitude,
)
