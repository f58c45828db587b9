from .raghavan import raghavan_upper_pvalue_bound
from .test import statistical_test, do_statistical_tests_per_edge
