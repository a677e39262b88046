"""Numerical operations: likelihood, KDE, summaries and the fused route."""

from .fused import (  # noqa: F401
    FusedCdfFallback,
    fused_fit_pdf,
    fused_route,
    kernels_available,
)
from .kde import (  # noqa: F401
    PDFDict,
    gaussian,
    kde_stack,
    kernel_matrix,
    kernel_matrix_dict,
    norm_rows,
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
    pdfs_summarize,
    summary_stream_step,
    unpack_summary,
)
