-- Bitwise unary op (DAIS opcode +/-9) on v = +/-a:
-- OP=0 NOT (WO bits), OP=1 OR-reduce (v /= 0), OP=2 AND-reduce over W0 bits.
library ieee;
use ieee.std_logic_1164.all;
use ieee.numeric_std.all;
use work.da4ml_util.all;

entity bit_unary is
    generic (
        WA : integer := 8;
        SA : integer := 1;
        W0 : integer := 8;
        NEG : integer := 0;
        OP : integer := 0;
        WO : integer := 8
    );
    port (
        a : in std_logic_vector(WA - 1 downto 0);
        o : out std_logic_vector(WO - 1 downto 0)
    );
end entity;

architecture rtl of bit_unary is
    constant WI : integer := imax(WA, WO) + 2;
    signal ea, v, r : signed(WI - 1 downto 0);
    signal vw : std_logic_vector(W0 - 1 downto 0);
begin
    ea <= ext(a, SA, WI);
    v <= -ea when NEG = 1 else ea;
    vw <= std_logic_vector(v(W0 - 1 downto 0));
    g_not : if OP = 0 generate
        r <= not v;
        o <= std_logic_vector(r(WO - 1 downto 0));
    end generate;
    g_any : if OP = 1 generate
        o <= std_logic_vector(to_unsigned(1, WO)) when unsigned(vw) /= 0
             else std_logic_vector(to_unsigned(0, WO));
        r <= (others => '0');
    end generate;
    g_all : if OP = 2 generate
        -- VHDL-2008 unary reduction
        o <= std_logic_vector(to_unsigned(1, WO)) when (and vw) = '1'
             else std_logic_vector(to_unsigned(0, WO));
        r <= (others => '0');
    end generate;
end architecture;
