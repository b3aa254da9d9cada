from .sharding import make_mesh, sharded_pairhmm_scores, sharded_genotype_step
