from .agm import agm_bound, fractional_edge_cover
from .device_graph import GraphDB, HybridGraphDB
from .engine import (ENGINES, count, execute, execute_stats, make_engine,
                     pick_engine)
from .gao import choose_gao
from .hybrid import HybridJoin
from .hypergraph import Hypergraph, all_neos, is_beta_acyclic, is_neo
from .plan import (GraphStats, HybridPlan, JoinPlan, LevelPlan,
                   compile_levels, executor_geometry)
from .planner import (PlanCache, candidate_gaos, candidate_plans,
                      choose_level_layouts, decompose_hybrid, plan_query)
from .query import (PAPER_QUERIES, Atom, LessThan, Query, get_query, parse)
from .vlftj import VLFTJ
from .yannakakis import CountingYannakakis, NotTreeShaped, variable_tree

__all__ = [
    "agm_bound", "fractional_edge_cover", "GraphDB", "HybridGraphDB",
    "ENGINES", "count", "execute", "execute_stats", "make_engine", "pick_engine",
    "choose_gao", "HybridJoin", "Hypergraph", "all_neos",
    "is_beta_acyclic", "is_neo", "GraphStats", "HybridPlan", "JoinPlan",
    "LevelPlan", "compile_levels", "executor_geometry", "PlanCache",
    "candidate_gaos", "candidate_plans", "choose_level_layouts",
    "decompose_hybrid", "plan_query", "PAPER_QUERIES", "Atom", "LessThan",
    "Query", "get_query", "parse", "VLFTJ", "CountingYannakakis",
    "NotTreeShaped", "variable_tree",
]
