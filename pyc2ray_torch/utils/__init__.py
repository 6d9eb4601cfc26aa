from .logutils import printlog
from .sourceutils import (format_sources, read_test_sources,
                          generate_test_sourcefile)
from .other_utils import get_redshifts_from_output, find_bins, get_source_redshifts

__all__ = ["printlog", "format_sources", "read_test_sources",
           "generate_test_sourcefile", "get_redshifts_from_output",
           "find_bins", "get_source_redshifts"]
