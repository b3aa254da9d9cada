from .measures import ALL_MEASURES, SiteContext, compute_measures
from .threshold import ThresholdFilter, parse_filter_expression
